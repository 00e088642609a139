"""The port's vision-language family (llama-3.2-vision-90b: dense layers
with a cross-attention injection over image embeddings after every
``cross_attn_every``-th) against the JAX reference: ``cross_attention``
and ``context_kv``, the reduced model's forward with a context and its
loss, ``fill_ctx_caches``, teacher-forced decode on filled and carried
context caches, the init layout, ``n_params``, ``serve`` on the CPU, and
ROADMAP C.10.  The checks shared with the audio family
(``tests/test_torch_audio.py``) are defined here.

Inputs are drawn with numpy from a seed, or the params come from the
reference's ``Model.init`` (+ ``quantize_params``), carried across by
``repro_torch.models.convert``.  Bounds, with the maxima measured on the
CPU (torch 2.13, jax 0.9.0; ``pytest -s`` prints them):

* ``context_kv`` / ``cross_attention`` at sq 1 and 5, rep 1 and 2, and
  at sq 1 and 8, rep 8 (whisper's too, ``tests/test_torch_audio.py``): 1e-5
  under ``fp32`` (measured 4.8e-7 at |out| ~ 2); 2e-2 under bf16 and W8A8,
  the dense family's bf16 bound (``tests/test_torch_serve.py``; measured
  1.2e-4 under bf16, 0 under W8A8).  Under W8A8 the context's keys and
  values come out of one per-tensor activation scale over the whole
  ``(b, n_ctx, d)`` context, as the reference's: 0 apart, bit for bit.
* reduced models: forward logits with a context and ``Model.loss``: 1e-5
  under ``fp32`` (measured 2.4e-7), 2e-2 under bf16 and W8A8 (measured:
  vlm 3.9e-3 / 4.9e-3, audio 3.9e-3 / 6.3e-3, one bf16 ulp at |logit| in
  [0.5, 2)).  The vlm forward feeds the context to ``context_kv`` uncast,
  as the reference's does, so under W8A8 its keys and values are float32.
* ``fill_ctx_caches`` against the reference's ``_fill_ctx_caches``: 2e-2
  (measured: vlm 0, bit for bit; audio 2.4e-4 under W8A8, 7.6e-5 under
  bf16, after its encoder).
* teacher-forced ``decode_step`` (8 steps, batch 2) on context caches
  filled by each side or carried from the reference's: logits and every
  cache after each step at 2e-2 (measured: logits <= 7.8e-3; ``k`` /
  ``v`` <= 3.9e-3 (vlm), <= 5.9e-3 (audio); carried context caches 0).
* the vlm in W4A8-pow2 too (its 100 layers fit one card only in that
  mode): forward logits 7.8e-3, fill 0, decode logits 7.8e-3, ``k`` /
  ``v`` 4.9e-3 / 4.2e-3, ``ctx_v`` 3.8e-6 filled by each side.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as r_get_config
from repro.configs.base import reduced as r_reduced
from repro.launch.serve import _fill_ctx_caches as r_fill_ctx_caches
from repro.models import attention as R_attn
from repro.models.model import Model as RModel
from repro.quant.policy import policy_for as r_policy_for
from repro.quant.qlinear import quantize_weight as r_quantize_weight
from repro.serving.scheduler import ContinuousBatcher as RBatcher
from repro.serving.scheduler import Request as RRequest
from repro_torch.configs import get_config
from repro_torch.configs.base import reduced
from repro_torch.launch.serve import fill_ctx_caches, generate, serve
from repro_torch.models import attention as T_attn
from repro_torch.models.convert import _leaf, from_reference_cache
from repro_torch.models.model import Model
from repro_torch.quant.policy import policy_for
from repro_torch.serving.scheduler import ContinuousBatcher
from test_torch_serve import _f32, _models, to_numpy_tree

TOL = 2e-2
FP32_TOL = 1e-5
STEPS = 8
BATCH = 2
VLM = "llama-3.2-vision-90b"
MODES = [("w8a8", True), ("bf16", False), ("fp32", False)]


def _tol(mode: str) -> float:
    return FP32_TOL if mode == "fp32" else TOL


def _ctx(cfg, seed: int, batch: int = BATCH) -> np.ndarray:
    """A context drawn as ``serve`` draws it: (b, n_ctx, d) x 0.02."""
    return (np.random.default_rng(seed).standard_normal(
        (batch, cfg.n_ctx_tokens, cfg.d_model)) * 0.02).astype(np.float32)


def _close(got, want, tol, what) -> float:
    err = float(np.max(np.abs(_f32(got) - _f32(want))))
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=tol, atol=tol,
                               err_msg=what)
    return err


# ------------------------------------------- cross_attention, context_kv

def _cross_params(cfg, seed):
    """Cross-layer weights at scale d_in^-0.5 (outputs O(1))."""
    rng = np.random.default_rng(seed)
    d, h, kvh, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim

    def w(shape):
        return (rng.standard_normal(shape) / np.sqrt(shape[0])) \
            .astype(np.float32)
    return {"wq_x": w((d, h * hd)), "wk_img": w((d, kvh * hd)),
            "wv_img": w((d, kvh * hd)), "wo_x": w((h * hd, d))}


@pytest.mark.parametrize("mode", ["fp32", "bf16", "w8a8"])
@pytest.mark.parametrize("sq", [1, 5])
@pytest.mark.parametrize("rep", [1, 2])
def test_cross_attention_and_context_kv_match_reference(mode, sq, rep):
    """The context's keys and values (``context_kv``, no RoPE) and the
    attention of x over them (the kv heads repeated ``rep`` times, no
    mask) against the reference's, on numpy inputs; under W8A8 on the
    reference's quantized weights carried across."""
    check_cross_attention(VLM, mode, sq, n_kv_heads=4 // rep)


@pytest.mark.parametrize("mode", ["fp32", "bf16", "w8a8"])
@pytest.mark.parametrize("sq", [1, 8])
def test_cross_attention_at_rep_8_matches_reference(mode, sq):
    """llama-3.2-vision's kv-head ratio (64 q heads over 8 kv heads: rep
    8) at one token and at eight: the port's ``cross_attention`` hands
    ``attend`` the context's kv heads unrepeated, and matches the
    reference's, which repeats them first."""
    check_cross_attention(VLM, mode, sq, n_heads=8, n_kv_heads=1)


def check_cross_attention(arch, mode, sq, **over):
    """``context_kv`` and ``cross_attention`` of ``arch`` reduced with
    ``over`` against the reference's (see
    ``test_cross_attention_and_context_kv_match_reference``)."""
    cfg = reduced(get_config(arch), quant="w8a8" if mode == "w8a8"
                  else mode, **over)
    rep = cfg.n_heads // cfg.n_kv_heads
    rng = np.random.default_rng(10 * sq + rep)
    x = rng.standard_normal((3, sq, cfg.d_model)).astype(np.float32)
    ctx = rng.standard_normal((3, cfg.n_ctx_tokens, cfg.d_model)) \
        .astype(np.float32)
    raw = _cross_params(cfg, sq + rep)
    rpol, tpol = r_policy_for(cfg.quant), policy_for(cfg.quant)
    rp = {k: jnp.asarray(v) for k, v in raw.items()}
    if mode == "w8a8":
        rp = {k: r_quantize_weight(v, rpol) for k, v in rp.items()}
        tp = {k: _carried(v) for k, v in rp.items()}
    else:
        tp = {k: torch.from_numpy(v) for k, v in raw.items()}
    rdt = jnp.float32 if mode == "fp32" else jnp.bfloat16
    tdt = torch.float32 if mode == "fp32" else torch.bfloat16
    rk, rv = R_attn.context_kv(jnp.asarray(ctx, rdt), rp, cfg, policy=rpol,
                               train=False)
    tk, tv = T_attn.context_kv(torch.from_numpy(ctx).to(tdt), tp, cfg,
                               policy=tpol)
    assert tuple(tk.shape) == (3, cfg.n_ctx_tokens, cfg.n_kv_heads,
                               cfg.head_dim) and tk.dtype == tdt
    errs = [_close(tk, rk, _tol(mode), "k"), _close(tv, rv, _tol(mode), "v")]
    want = R_attn.cross_attention(jnp.asarray(x, rdt), rk, rv, rp, cfg,
                                  policy=rpol, train=False)
    got = T_attn.cross_attention(torch.from_numpy(x).to(tdt), tk, tv, tp,
                                 cfg, policy=tpol)
    assert got.dtype == tdt and tuple(got.shape) == x.shape
    errs.append(_close(got, want, _tol(mode), "out"))
    print(arch, mode, sq, rep, "k, v, out", errs, "max|out|",
          float(np.abs(_f32(want)).max()))


def _carried(qw):
    """One reference QuantizedTensor as the port's."""
    return _leaf(to_numpy_tree(qw), None, torch.device("cpu"))


# -------------------------------------------- shared model-level checks

def check_forward_and_loss(arch, mode, quantize):
    """Reduced ``arch``'s forward at (2, 9) tokens with a context, logits
    against the reference's, and ``Model.loss`` with ``batch["ctx"]``."""
    rmodel, rparams, tmodel, tparams = _models(arch, mode, quantize)
    cfg = tmodel.cfg
    toks = np.random.default_rng(2).integers(0, cfg.vocab, (BATCH, 10))
    ctx = _ctx(cfg, 3)
    want, _ = rmodel.forward(rparams, jnp.asarray(toks[:, :9], jnp.int32),
                             ctx=jnp.asarray(ctx))
    got, aux = tmodel.forward(tparams, torch.from_numpy(toks[:, :9]),
                              ctx=torch.from_numpy(ctx))
    assert tuple(got.shape) == (BATCH, 9, cfg.vocab) and float(aux) == 0.0
    err = _close(got, want, _tol(mode), "logits")
    batch = {"tokens": toks[:, :9], "labels": toks[:, 1:]}
    want_loss = rmodel.loss(rparams, {
        "tokens": jnp.asarray(batch["tokens"], jnp.int32),
        "labels": jnp.asarray(batch["labels"], jnp.int32),
        "ctx": jnp.asarray(ctx)}, train=False)
    got_loss = tmodel.loss(tparams, {
        "tokens": torch.from_numpy(batch["tokens"]),
        "labels": torch.from_numpy(batch["labels"]),
        "ctx": torch.from_numpy(ctx)}, train=False)
    loss_err = abs(float(got_loss) - float(want_loss))
    print(arch, mode, quantize, "logits", err, "loss", float(got_loss),
          float(want_loss))
    assert loss_err <= _tol(mode) * max(1.0, abs(float(want_loss)))
    with pytest.raises(ValueError, match="needs ctx"):
        tmodel.forward(tparams, torch.from_numpy(toks[:, :9]))


def check_fill_ctx_caches(arch, mode, quantize):
    """``fill_ctx_caches`` against the reference's ``_fill_ctx_caches`` on
    the same context: every cross layer's keys and values, in the cache
    dtype; the other caches stay zero."""
    rmodel, rparams, tmodel, tparams = _models(arch, mode, quantize)
    ctx = _ctx(tmodel.cfg, 4)
    rc = r_fill_ctx_caches(rmodel, rparams, rmodel.init_cache(BATCH, 6),
                           jnp.asarray(ctx))
    tc = tmodel.init_cache(BATCH, 6)
    out = fill_ctx_caches(tmodel, tparams, tc, torch.from_numpy(ctx))
    assert out is tc and set(tc) == set(rc) == {"k", "v", "ctx_k", "ctx_v"}
    errs = {}
    for name in ("ctx_k", "ctx_v"):
        assert tc[name].dtype == torch.bfloat16
        assert tuple(tc[name].shape) == rc[name].shape
        errs[name] = _close(tc[name], rc[name], TOL, name)
        assert bool(tc[name].abs().amax(dim=(1, 2, 3, 4)).gt(0).all())
    assert not tc["k"].any() and not tc["v"].any()
    print(arch, mode, "fill", errs)
    return errs


def _compare_caches(rc, tc, where) -> dict:
    assert set(rc) == set(tc)
    return {name: _close(tc[name], rc[name], TOL, f"{name} {where}")
            for name in rc}


def check_teacher_forced_decode(arch, mode, quantize, carried):
    """``STEPS`` teacher-forced ``decode_step``s at batch 2: the context
    caches filled by each side's own fill (``carried`` False) or the
    reference's, carried across by ``from_reference_cache``; logits and
    every cache after each step."""
    rmodel, rparams, tmodel, tparams = _models(arch, mode, quantize)
    cfg = tmodel.cfg
    ctx = _ctx(cfg, 5)
    toks = np.random.default_rng(6).integers(0, cfg.vocab, (BATCH, STEPS))
    rc = r_fill_ctx_caches(rmodel, rparams,
                           rmodel.init_cache(BATCH, STEPS),
                           jnp.asarray(ctx))
    if carried:
        tc = from_reference_cache(tmodel, to_numpy_tree(rc), device="cpu")
        for name in rc:
            assert np.array_equal(_f32(tc[name]), _f32(rc[name]))
    else:
        tc = fill_ctx_caches(tmodel, tparams,
                             tmodel.init_cache(BATCH, STEPS),
                             torch.from_numpy(ctx))
    decode = jax.jit(rmodel.decode_step)
    worst = {"logits": 0.0}
    for i in range(STEPS):
        tok = toks[:, i:i + 1]
        rl, rc = decode(rparams, rc, jnp.asarray(tok, jnp.int32),
                        jnp.int32(i))
        tl, tc = tmodel.decode_step(tparams, tc, torch.from_numpy(tok), i)
        assert tl.dtype == torch.bfloat16 \
            and tuple(tl.shape) == (BATCH, 1, cfg.vocab)
        worst["logits"] = max(worst["logits"],
                              _close(tl, rl, TOL, f"logits at {i}"))
        for k, e in _compare_caches(rc, tc, f"at step {i}").items():
            worst[k] = max(worst.get(k, 0.0), e)
    print(arch, mode, quantize, "carried" if carried else "filled", worst)


def check_init_layout(arch):
    """``init`` draws the reference's keys and shapes (``param_shapes``),
    the cross and encoder layers as lists; ``init(quantize=True)`` equals
    ``quantize_params(init())``, every projection int8."""
    cfg = reduced(get_config(arch))
    want = jax.tree.map(lambda a: tuple(a.shape),
                        RModel(r_reduced(r_get_config(arch))).param_shapes())
    model = Model(cfg, device="cpu")
    params = model.init(torch.Generator("cpu").manual_seed(0))
    assert params.keys() == want.keys()
    for key in ("layers", "cross_layers", "encoder_layers"):
        if key not in want:
            continue
        n = next(iter(want[key].values()))[0]
        assert len(params[key]) == n, key
        for lp in params[key]:
            assert lp.keys() == want[key].keys(), key
            for name, t in lp.items():
                assert tuple(t.shape) == want[key][name][1:], (key, name)
                assert t.dtype == torch.float32
    for key in ("embed", "final_norm"):
        assert tuple(params[key].shape) == want[key]
    q = model.init(torch.Generator("cpu").manual_seed(0), quantize=True)
    again = model.quantize_params(params)
    for key in ("cross_layers", "encoder_layers", "layers"):
        for lq, la in zip(q.get(key, []), again.get(key, [])):
            for name, t in lq.items():
                if name.startswith("ln"):
                    assert torch.equal(t, la[name])
                    continue
                assert t.data.dtype == torch.int8, (key, name)
                assert torch.equal(t.data, la[name].data), (key, name)
                assert torch.equal(t.scale, la[name].scale), (key, name)


def check_n_params(arch):
    """``n_params`` (the reference's formula, quirks and all: ROADMAP
    C.11) at full and reduced size; the full config's model builds."""
    r, t = r_get_config(arch), get_config(arch)
    assert Model(t, device="cpu").cfg is t
    assert t.n_params() == r.n_params()
    assert reduced(t).n_params() == r_reduced(r).n_params()
    assert t.n_active_params() == r.n_active_params()
    return t.n_params()


def check_serve_cpu(arch):
    res = serve(arch, batch=2, prompt_len=4, gen=5, quantize=True,
                device="cpu")
    toks = res["tokens"]
    assert toks.dtype == torch.int32 and tuple(toks.shape) == (2, 5)
    assert int(toks.min()) >= 0 and int(toks.max()) < 256
    again = serve(arch, batch=2, prompt_len=4, gen=5, quantize=True,
                  device="cpu")
    assert torch.equal(again["tokens"], toks)
    # generate on caches filled beforehand gives the same tokens
    model = Model(reduced(get_config(arch)), device="cpu")
    params = model.init(torch.Generator("cpu").manual_seed(0),
                        quantize=True)
    prompts = torch.randint(0, 256, (2, 4),
                            generator=torch.Generator("cpu").manual_seed(1))
    ctx = torch.randn((2, model.cfg.n_ctx_tokens, model.cfg.d_model),
                      generator=torch.Generator("cpu").manual_seed(2)) * 0.02
    caches = fill_ctx_caches(model, params, model.init_cache(2, 9), ctx)
    assert torch.equal(generate(model, params, prompts, gen=5,
                                caches=caches)["tokens"], toks)
    with pytest.raises(ValueError, match="needs ctx"):
        generate(model, params, prompts, gen=5)


def pin_reference_c10(arch):
    """ROADMAP C.10, pinned on the reference: ``prefill(ctx=)`` returns
    context caches that are all zero (it inits the caches and replays the
    prompt, never filling them), and the batcher inits them to zero and
    leaves them so through a run.  If this starts failing, the reference
    changed: revisit the port's refusals."""
    rcfg = r_reduced(r_get_config(arch))
    model = RModel(rcfg)
    params = model.init(jax.random.key(0))
    toks = jnp.asarray(np.random.default_rng(7).integers(0, 256, (2, 5)),
                       jnp.int32)
    ctx = jnp.asarray(_ctx(rcfg, 8))
    _, caches = model.prefill(params, toks, ctx=ctx, max_seq=8)
    assert not np.asarray(caches["ctx_k"]).any()
    assert not np.asarray(caches["ctx_v"]).any()
    assert np.asarray(caches["k"]).any()
    bat = RBatcher(model, params, n_slots=2, max_seq=16)
    assert not np.asarray(bat.caches["ctx_k"]).any()
    bat.submit(RRequest(rid=0, prompt=[5, 6], max_new=3))
    bat.run()
    assert np.asarray(bat.caches["k"]).any()
    assert not np.asarray(bat.caches["ctx_k"]).any()
    assert not np.asarray(bat.caches["ctx_v"]).any()


def check_port_refusals(arch):
    """The port's ``prefill`` and ``ContinuousBatcher`` refuse the family,
    naming C.10; int8 KV is refused, as the reference refuses it."""
    model = Model(reduced(get_config(arch)), device="cpu")
    params = model.init(torch.Generator("cpu").manual_seed(0))
    toks = torch.zeros((1, 3), dtype=torch.int64)
    with pytest.raises(NotImplementedError, match="ROADMAP C.10"):
        model.prefill(params, toks)
    with pytest.raises(NotImplementedError, match="ROADMAP C.10"):
        ContinuousBatcher(model, params, n_slots=2, max_seq=8)
    with pytest.raises(NotImplementedError, match="int8 KV"):
        model.init_cache(2, 8, kv_quant=True)
    with pytest.raises(NotImplementedError, match="int8 KV"):
        RModel(r_reduced(r_get_config(arch))).init_cache(2, 8,
                                                         kv_quant=True)


# ---------------------------------------------------------- the vlm

# the vlm also in W4A8-pow2, the mode its 100 layers are served in on one
# card
W4A8 = ("w4a8_pow2", True)


@pytest.mark.parametrize("mode,quantize", MODES + [W4A8])
def test_forward_and_loss_match_reference(mode, quantize):
    check_forward_and_loss(VLM, mode, quantize)


@pytest.mark.parametrize("mode,quantize", [("w8a8", True), ("bf16", False),
                                           W4A8])
def test_fill_ctx_caches_matches_reference(mode, quantize):
    check_fill_ctx_caches(VLM, mode, quantize)


@pytest.mark.parametrize("carried", [False, True])
@pytest.mark.parametrize("mode,quantize", [("w8a8", True), ("bf16", False),
                                           W4A8])
def test_teacher_forced_decode_matches_reference(mode, quantize, carried):
    check_teacher_forced_decode(VLM, mode, quantize, carried)


def test_init_draws_the_reference_layout():
    check_init_layout(VLM)
    params = Model(reduced(get_config(VLM)), device="cpu").init(
        torch.Generator("cpu").manual_seed(0))
    assert len(params["cross_layers"]) == 1 and "encoder_layers" not in params


def test_n_params_matches_reference():
    """By the reference's count llama-3.2-vision-90b has 103.7e9
    parameters (a cross layer counted with an MLP it does not have)."""
    assert round(check_n_params(VLM) / 1e9, 1) == 103.7


def test_serve_cpu_end_to_end():
    check_serve_cpu(VLM)


def test_reference_prefill_and_batcher_leave_context_caches_zero():
    pin_reference_c10(VLM)


def test_port_refuses_prefill_batching_and_int8_kv():
    check_port_refusals(VLM)


def test_vlm_depth_must_be_whole_groups_and_full_width_needs_quant():
    cfg = reduced(get_config(VLM), n_layers=3)
    with pytest.raises(ValueError, match="whole groups"):
        Model(cfg, device="cpu")
    with pytest.raises(ValueError, match="--quant"):
        serve(VLM, smoke=False, device="cpu")
