"""The port's quantized serving slice against the JAX reference.

Reduced-width models get their params from the reference
(``Model.init`` + ``Model.quantize_params``), carried across by
``repro_torch.models.convert.from_reference_params``; both
``decode_step``s are then teacher-forced over the same tokens, and the
logits and k/v caches are compared after every step.

Tolerance ``rtol = atol = 2e-2``: both sides compute in bf16
(``tests/test_kernels.py`` holds bf16 paths to the same bound), and the
W4A8 plain version sums exactly where the reference sums in float32.
starcoder2-7b and deepseek-67b keep their published head ratios (36 over
4, 64 over 8 KV heads) at reduced width.  Measured maximum absolute
differences over the 8 steps (CPU, torch 2.13, jax 0.9.0): logits
5.9e-3 to 7.8e-3 (one bf16 ulp at |logit| in [1, 2): the two frameworks
round bf16 elementwise ops at other places); k/v caches 4.2e-3 / 3.9e-3
(phi4 W8A8), 3.9e-3 / 4.9e-3 (phi4 W4A8-pow2), 6.1e-3 / 5.9e-3
(starcoder2 W8A8, gelu), 6.8e-3 / 5.9e-3 (starcoder2 W4A8-pow2), 3.9e-3
/ 3.9e-3 (deepseek W8A8), 4.8e-3 / 3.9e-3 (deepseek W4A8-pow2), 2.0e-3 /
2.0e-3 (phi4 unquantized bf16); on int8 KV caches, dequantized, logits
<= 8.8e-3 and k/v <= 1.04e-2.  ``pytest -s`` prints each run's maxima.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as r_get_config
from repro.configs.base import reduced as r_reduced
from repro.models import attention as R_attn
from repro.models.model import Model as RModel
from repro.quant.policy import policy_for as r_policy_for
from repro.quant.qlinear import QuantizedTensor as RQuantizedTensor
from repro_torch.configs import get_config
from repro_torch.configs.base import reduced
from repro_torch.launch.serve import serve
from repro_torch.models import attention as T_attn
from repro_torch.models.convert import from_reference_params
from repro_torch.models.model import Model
from repro_torch.quant.policy import policy_for

TOL = 2e-2
STEPS = 8
BATCH = 3


def to_numpy_tree(tree):
    """A reference params pytree as nested dicts of numpy arrays."""
    if isinstance(tree, RQuantizedTensor):
        return {"data": np.asarray(tree.data),
                "scale": np.asarray(tree.scale), "mode": tree.mode,
                "orig_shape": tuple(tree.orig_shape)}
    if isinstance(tree, dict):
        return {k: to_numpy_tree(v) for k, v in tree.items()}
    return np.asarray(tree)


def _f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.to(torch.float32).numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


# each model's published head ratio, kept at reduced width: deepseek-67b's
# 64 heads over 8 KV heads (rep 8), starcoder2-7b's 36 over 4 (rep 9)
HEADS = {"deepseek-67b": (64, 8), "starcoder2-7b": (36, 4)}


def _models(arch, mode, quantize):
    heads = dict(zip(("n_heads", "n_kv_heads"), HEADS.get(arch, ())))
    rcfg = dataclasses.replace(r_reduced(r_get_config(arch), **heads),
                               quant=mode)
    tcfg = dataclasses.replace(reduced(get_config(arch), **heads),
                               quant=mode)
    rmodel = RModel(rcfg)
    rparams = rmodel.init(jax.random.key(0))
    if quantize:
        rparams = rmodel.quantize_params(rparams)
    tmodel = Model(tcfg, device="cpu")
    tparams = from_reference_params(tcfg, to_numpy_tree(rparams),
                                    device="cpu")
    return rmodel, rparams, tmodel, tparams


CASES = [("phi4-mini-3.8b", "w8a8", True),
         ("phi4-mini-3.8b", "w4a8_pow2", True),
         ("starcoder2-7b", "w8a8", True),
         ("phi4-mini-3.8b", "w8a8", False),
         ("deepseek-67b", "w8a8", True),
         ("deepseek-67b", "w4a8_pow2", True),
         ("starcoder2-7b", "w4a8_pow2", True)]


def _kv(cache, name, kv_quant) -> np.ndarray:
    """A k or v cache as float32, an int8 one times its per-(position,
    head) scales."""
    if kv_quant:
        return _f32(cache[name]) * _f32(cache[f"{name}_scale"])[..., None]
    return _f32(cache[name])


def _teacher_forced(arch, mode, quantize, kv_quant):
    rmodel, rparams, tmodel, tparams = _models(arch, mode, quantize)
    cfg = tmodel.cfg
    tokens = np.random.default_rng(1).integers(0, cfg.vocab,
                                               (BATCH, STEPS))
    rcache = rmodel.init_cache(BATCH, STEPS, kv_quant=kv_quant)
    tcache = tmodel.init_cache(BATCH, STEPS, kv_quant=kv_quant)
    assert set(rcache) == set(tcache)
    decode = jax.jit(rmodel.decode_step)
    worst = {"logits": 0.0, "k": 0.0, "v": 0.0}
    for i in range(STEPS):
        rlog, rcache = decode(rparams, rcache,
                              jnp.asarray(tokens[:, i:i + 1], jnp.int32),
                              jnp.int32(i))
        tlog, tcache = tmodel.decode_step(
            tparams, tcache, torch.from_numpy(tokens[:, i:i + 1]), i)
        assert tlog.dtype == torch.bfloat16
        assert tuple(tlog.shape) == (BATCH, 1, cfg.vocab)
        for name, r, t in (
                ("logits", _f32(rlog), _f32(tlog)),
                ("k", _kv(rcache, "k", kv_quant), _kv(tcache, "k", kv_quant)),
                ("v", _kv(rcache, "v", kv_quant),
                 _kv(tcache, "v", kv_quant))):
            worst[name] = max(worst[name], float(np.max(np.abs(r - t))))
            np.testing.assert_allclose(t, r, rtol=TOL, atol=TOL,
                                       err_msg=f"{name} at step {i}")
    print(arch, mode, quantize, "int8 KV" if kv_quant else "bf16 KV", worst)


@pytest.mark.parametrize("arch,mode,quantize", CASES)
def test_decode_matches_reference(arch, mode, quantize):
    _teacher_forced(arch, mode, quantize, kv_quant=False)


@pytest.mark.parametrize("arch,mode", [(a, m) for a, m, _ in CASES
                                       if a in HEADS])
def test_decode_on_int8_kv_matches_reference(arch, mode):
    """starcoder2-7b and deepseek-67b at their published head ratios
    (rep 9, rep 8) on int8 KV caches: the decode kernel's shapes on the
    card, its plain version here."""
    _teacher_forced(arch, mode, True, kv_quant=True)


@pytest.mark.parametrize("mode", ["w8a8", "w4a8_pow2"])
def test_quantize_params_bit_identical(mode):
    """The port quantizes the reference's float params to the same
    integers and scales as the reference's ``quantize_params``."""
    rmodel, rparams, tmodel, tparams = _models("phi4-mini-3.8b", mode,
                                               quantize=False)
    want = from_reference_params(
        tmodel.cfg, to_numpy_tree(rmodel.quantize_params(rparams)),
        device="cpu")
    got = tmodel.quantize_params(tparams)
    torch.testing.assert_close(got["embed"], want["embed"], rtol=0, atol=0)
    for lg, lw in zip(got["layers"], want["layers"]):
        assert lg.keys() == lw.keys()
        for name in lg:
            if name.startswith("ln"):
                assert torch.equal(lg[name], lw[name])
                continue
            assert lg[name].mode == lw[name].mode == mode
            assert lg[name].orig_shape == lw[name].orig_shape
            assert torch.equal(lg[name].data, lw[name].data), name
            assert torch.equal(lg[name].scale, lw[name].scale), name


def test_decode_attention_matches_reference():
    """One attention layer on bf16 float weights against the
    reference's."""
    _, rparams, tmodel, tparams = _models("phi4-mini-3.8b", "bf16", False)
    cfg = tmodel.cfg
    rng = np.random.default_rng(3)
    S, pos = 8, 5
    x = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
    ck = rng.standard_normal((2, S, cfg.n_kv_heads, cfg.head_dim)) \
        .astype(np.float32)
    cv = rng.standard_normal(ck.shape).astype(np.float32)
    lp_r = jax.tree.map(lambda a: a[0], rparams["layers"])
    out_r, nk_r, nv_r = R_attn.decode_self_attention(
        jnp.asarray(x, jnp.bfloat16), lp_r, cfg, jnp.asarray(ck, jnp.bfloat16),
        jnp.asarray(cv, jnp.bfloat16), jnp.int32(pos),
        policy=r_policy_for("bf16"))
    out_t, nk_t, nv_t = T_attn.decode_self_attention(
        torch.from_numpy(x).to(torch.bfloat16), tparams["layers"][0], cfg,
        torch.from_numpy(ck).to(torch.bfloat16),
        torch.from_numpy(cv).to(torch.bfloat16), pos,
        policy=policy_for("bf16"))
    for r, t in ((out_r, out_t), (nk_r, nk_t), (nv_r, nv_t)):
        np.testing.assert_allclose(_f32(t), _f32(r), rtol=TOL, atol=TOL)


def test_decode_attention_refuses_unported_paths():
    """A dynamic decode ``window`` on the int8 cache is refused on the
    kernel route (the kernel masks ``s <= pos`` alone, ROADMAP A.6), before
    any cache is written; the plain route and the bf16 cache take it, and
    ring and slice windows run everywhere (``tests/test_torch_window.py``)."""
    _, _, tmodel, tparams = _models("phi4-mini-3.8b", "bf16", False)
    cfg = tmodel.cfg
    x = torch.ones((1, 1, cfg.d_model), dtype=torch.bfloat16)
    c8 = torch.zeros((1, 4, cfg.n_kv_heads, cfg.head_dim), dtype=torch.int8)
    sc = torch.zeros((1, 4, cfg.n_kv_heads))
    lp, pol = tparams["layers"][0], policy_for("bf16")
    for pos in (0, torch.tensor([2])):
        with pytest.raises(NotImplementedError, match="ROADMAP A.6"):
            T_attn.decode_self_attention(x, lp, cfg, c8, c8, pos, policy=pol,
                                         window=2, kv_scales=(sc, sc),
                                         impl="kernel")
    assert not c8.any() and not sc.any()
    out = T_attn.decode_self_attention(x, lp, cfg, c8, c8.clone(), 0,
                                       policy=pol, window=2,
                                       kv_scales=(sc, sc.clone()))
    assert tuple(out[0].shape) == (1, 1, cfg.d_model)
    cb = torch.zeros((1, 4, cfg.n_kv_heads, cfg.head_dim),
                     dtype=torch.bfloat16)
    out = T_attn.decode_self_attention(x, lp, cfg, cb, cb.clone(), 0,
                                       policy=pol, window=2, impl="kernel")
    assert tuple(out[0].shape) == (1, 1, cfg.d_model)


@pytest.mark.parametrize("family,extra", [("rnn", {}), ("diffusion", {})])
def test_model_refuses_unported_families(family, extra):
    """A family that neither the reference nor the port has is refused
    (all six of the reference's are ported)."""
    cfg = dataclasses.replace(reduced(get_config("phi4-mini-3.8b")),
                              family=family, **extra)
    with pytest.raises(NotImplementedError, match="no model family"):
        Model(cfg, device="cpu")


@pytest.mark.parametrize("quantize", [True, False])
def test_serve_cpu_end_to_end(quantize):
    res = serve("phi4-mini-3.8b", batch=2, prompt_len=4, gen=5,
                quantize=quantize, device="cpu")
    assert set(res) == {"tokens", "prefill_s", "decode_s", "tok_per_s"}
    toks = res["tokens"]
    assert toks.dtype == torch.int32 and tuple(toks.shape) == (2, 5)
    assert int(toks.min()) >= 0 and int(toks.max()) < 256
    assert res["tok_per_s"] > 0
    again = serve("phi4-mini-3.8b", batch=2, prompt_len=4, gen=5,
                  quantize=quantize, device="cpu")
    assert torch.equal(again["tokens"], toks)
    with pytest.raises(NotImplementedError, match="greedy"):
        serve("phi4-mini-3.8b", greedy=False, device="cpu")


def test_serve_cuda_refused_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve("phi4-mini-3.8b", quantize=True)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Model(reduced(get_config("phi4-mini-3.8b")))


def test_init_draws_on_the_model_device_layer_by_layer():
    model = Model(reduced(get_config("phi4-mini-3.8b"), n_layers=3),
                  device="cpu")
    params = model.init(torch.Generator("cpu").manual_seed(0),
                        quantize=True)
    assert len(params["layers"]) == 3
    lp = params["layers"][0]
    assert lp["wq"].data.dtype == torch.int8
    assert tuple(lp["w_down"].data.shape) == (128, 64)
    assert params["embed"].dtype == torch.float32
    again = model.init(torch.Generator("cpu").manual_seed(0))
    q = model.quantize_params(again)
    assert torch.equal(q["layers"][2]["wo"].data,
                       params["layers"][2]["wo"].data)


def _chip_smoke():
    import importlib.util
    import pathlib
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("arch,per_layer", [("starcoder2-7b", 6),
                                            ("phi4-mini-3.8b", 7)])
def test_dense_products_match_a_decode_step(arch, per_layer, monkeypatch):
    """``chip_smoke._dense_products`` (the launch count its checks expect
    of a dense layer) equals the ``serve_dot`` calls one decode step
    makes a layer: 6 for starcoder2's gelu MLP, 7 for SwiGLU."""
    from repro_torch.quant import qlinear
    cfg = reduced(get_config(arch), n_layers=3)
    assert _chip_smoke()._dense_products(cfg) == per_layer
    model = Model(cfg, device="cpu")
    params = model.init(torch.Generator("cpu").manual_seed(0),
                        quantize=True)
    calls, real = [], qlinear.serve_dot

    def counting(*args, **kwargs):
        calls.append(args[1].orig_shape)
        return real(*args, **kwargs)
    monkeypatch.setattr(qlinear, "serve_dot", counting)
    model.decode_step(params, model.init_cache(2, 4),
                      torch.zeros((2, 1), dtype=torch.int64), 0)
    assert len(calls) == per_layer * cfg.n_layers


def test_serve_refuses_float32_past_device_memory(monkeypatch):
    """deepseek-67b at full width without ``quantize`` is refused before
    anything is drawn: its float32 params (266.4 GB by the reference's
    count) pass the host's memory as they pass an 80 GB card."""
    from repro_torch.launch import serve as serve_mod

    def no_draw(*args, **kwargs):
        raise AssertionError("serve drew params before refusing")
    monkeypatch.setattr(Model, "init", no_draw)
    monkeypatch.setattr(serve_mod.torch, "randint", no_draw)
    with pytest.raises(ValueError, match=r"266\.4 GB of float32 params.*"
                                         r"--quant"):
        serve("deepseek-67b", smoke=False, device="cpu")
    monkeypatch.setattr(serve_mod, "device_memory_bytes",
                        lambda dev: 80 * 2 ** 30)
    with pytest.raises(ValueError, match="--quant"):
        serve("deepseek-67b", smoke=False, device="cpu")
