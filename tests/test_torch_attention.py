"""The port's attention slice against the JAX reference: the int8-KV
decode attention, flash attention, the full-sequence forward and the
int8-KV decode of the dense models.

Inputs are drawn with numpy from a seed and handed to both packages.
Bounds, each with its measured maximum (CPU, torch 2.13, jax 0.9.0):

* plain ``w8a8_decode_attention`` vs ``ref.w8a8_decode_attention_ref``
  and vs the Pallas kernel in interpret mode: 1e-5, the reference's own
  kernel-vs-oracle bound (``tests/test_kernels_decode.py``); measured
  1.2e-7 against each.
* int8-KV attention core of ``decode_self_attention`` vs the reference's
  model branch, same q and caches: 1e-5 x max|out|; measured 6.7e-8
  (the two normalise the probabilities in another order).
* plain ``flash_attention`` vs ``ref.flash_attention_ref`` and the Pallas
  kernel: 1e-5 (f32) and 2e-2 (bf16), the bounds of
  ``tests/test_kernels.py``; measured 7.2e-7 (f32) and 7.8e-3 (bf16,
  one ulp: the reference's oracle rounds the scale to bf16).
* ``Model.forward`` vs the reference's ``forward`` on converted params,
  and the int8-KV ``decode_step`` (logits, dequantized caches): 2e-2,
  the bf16 bound of ``tests/test_torch_serve.py``; measured 7.8e-3
  (forward and decode logits), caches 8.1e-3.
* the port's int8-KV decode replayed over a prompt vs its own forward:
  5e-2 x max|logit|, the bound ``tests/test_perf_paths.py`` holds the
  reference to; measured 5.7e-3.

``pytest -s`` prints each run's maxima.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as R_ref
from repro.kernels.flash_attention import flash_attention as R_flash
from repro.kernels.w8a8_decode import w8a8_decode_attention as R_w8dec
from repro.models import attention as R_attn
from repro.quant.policy import policy_for as r_policy_for
from repro_torch.kernels import ops
from repro_torch.kernels import w8a8_decode as T_dec
from repro_torch.models import attention as T_attn
from repro_torch.quant.policy import policy_for
from test_torch_serve import CASES, _f32, _models

TOL = 2e-2
KERNEL_TOL = 1e-5


def _decode_inputs(seed, b, kvh, rep, hd, S):
    """As ``tests/test_kernels_decode.py`` draws them."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, kvh, rep, hd)).astype(np.float32)
    kf = rng.standard_normal((b, S, kvh, hd)).astype(np.float32)
    vf = rng.standard_normal((b, S, kvh, hd)).astype(np.float32)
    ks = (np.abs(kf).max(-1) / 127.0).astype(np.float32)
    vs = (np.abs(vf).max(-1) / 127.0).astype(np.float32)
    kq = np.round(kf / ks[..., None]).astype(np.int8)
    vq = np.round(vf / vs[..., None]).astype(np.int8)
    return q, kq, vq, ks, vs


DECODE_SHAPES = [(2, 2, 4, 32, 128, 32), (1, 4, 2, 16, 64, 16),
                 (2, 1, 8, 64, 96, 32)]


@pytest.mark.parametrize("b,kvh,rep,hd,S,bs", DECODE_SHAPES)
def test_w8a8_decode_plain_matches_oracle_and_pallas(b, kvh, rep, hd, S, bs):
    arrays = _decode_inputs(b * 7, b, kvh, rep, hd, S)
    jx = [jnp.asarray(a) for a in arrays]
    tt = [torch.from_numpy(a) for a in arrays]
    worst = [0.0, 0.0]
    for pos in (0, S // 2, S - 1):
        got = ops.w8a8_decode_attention(*tt, pos, bs=bs).numpy()
        oracle = np.asarray(R_ref.w8a8_decode_attention_ref(
            *jx, jnp.int32(pos), bs=bs))
        pallas = np.asarray(R_w8dec(*jx, jnp.int32(pos), bs=bs,
                                    interpret=True))
        for i, want in enumerate((oracle, pallas)):
            worst[i] = max(worst[i], float(np.max(np.abs(got - want))))
            np.testing.assert_allclose(got, want, rtol=KERNEL_TOL,
                                       atol=KERNEL_TOL)
    print((b, kvh, rep, hd, S, bs), "vs oracle / pallas", worst)


def test_w8a8_decode_per_slot_positions_match_per_row_oracle():
    """A (b,) position vector gives each row the oracle's answer at its
    own scalar position; the body with ``bs = S`` is the one-block form."""
    b, kvh, rep, hd, S = 3, 2, 3, 32, 64
    arrays = _decode_inputs(5, b, kvh, rep, hd, S)
    jx = [jnp.asarray(a) for a in arrays]
    tt = [torch.from_numpy(a) for a in arrays]
    pos = np.array([0, 29, S - 1], np.int32)
    for bs in (16, S):
        got = ops.w8a8_decode_attention(*tt, torch.from_numpy(pos),
                                        bs=bs).numpy()
        for i, p in enumerate(pos):
            want = np.asarray(R_ref.w8a8_decode_attention_ref(
                *jx, jnp.int32(p), bs=bs))[i]
            np.testing.assert_allclose(got[i], want, rtol=KERNEL_TOL,
                                       atol=KERNEL_TOL)
    scalar = ops.w8a8_decode_attention(*tt, 17, bs=16)
    vector = ops.w8a8_decode_attention(*tt, torch.full((b,), 17), bs=16)
    assert torch.equal(scalar, vector)


def test_w8a8_decode_checks_its_operands():
    tt = [torch.from_numpy(a) for a in _decode_inputs(1, 1, 2, 2, 16, 64)]
    with pytest.raises(ValueError, match="divisible by the block size"):
        ops.w8a8_decode_attention(*tt, 3, bs=48)
    with pytest.raises(ValueError, match="below 2\\^31"):
        ops.w8a8_decode_attention(*tt, 3, bs=64 * 4096)
    with pytest.raises(ValueError, match="shape"):
        ops.w8a8_decode_attention(*tt, torch.zeros(2, dtype=torch.int32),
                                  bs=16)
    with pytest.raises(ValueError, match="CUDA tensors"):
        T_dec.w8a8_decode_attention(*tt, 3, bs=16)
    with pytest.raises(ValueError, match="impl must be one of"):
        ops.w8a8_decode_attention(*tt, 3, bs=16, impl="pallas")


# ------------------------------------------------ the model's int8 branch

def _identity_layer(cfg):
    """Projections that hand x through unchanged: q = x, k = x[:, :kvh*hd],
    v = x[:, kvh*hd:2*kvh*hd] (bf16-exact on bf16-representable x)."""
    d, kv = cfg.d_model, cfg.n_kv_heads * cfg.head_dim
    eye = np.eye(d, dtype=np.float32)
    return {"wq": eye, "wk": eye[:, :kv].copy(), "wv": eye[:, kv:2 * kv].copy(),
            "wo": eye}


def test_int8_kv_attention_core_matches_reference(monkeypatch):
    """The int8-KV attention core of ``decode_self_attention`` against the
    reference's model branch (``attention.py:270-301``) on the same q and
    caches, per-slot positions 0 among them: RoPE is taken out and the
    output projection intercepted on both sides, so the projections and
    rotations of the two frameworks (which may round bf16 differently)
    cannot move q or the new cache rows."""
    _, _, tmodel, _ = _models("phi4-mini-3.8b", "bf16", False)
    cfg = tmodel.cfg
    b, S = 3, 16
    kvh, hd = cfg.n_kv_heads, cfg.head_dim
    rng = np.random.default_rng(11)
    x = np.array(jnp.asarray(rng.standard_normal((b, 1, cfg.d_model)),
                             jnp.bfloat16).astype(jnp.float32))
    ck = rng.integers(-127, 128, (b, S, kvh, hd)).astype(np.int8)
    cv = rng.integers(-127, 128, (b, S, kvh, hd)).astype(np.int8)
    ks = rng.uniform(1e-3, 2e-2, (b, S, kvh)).astype(np.float32)
    vs = rng.uniform(1e-3, 2e-2, (b, S, kvh)).astype(np.float32)
    pos = np.array([0, 9, S - 1], np.int32)
    lp = _identity_layer(cfg)

    for mod in (R_attn, T_attn):
        monkeypatch.setattr(mod, "rope", lambda t, *a, **k: t)
        real = mod.qdot

        def qdot(t, w, *a, _real=real, **k):
            return t if w is wo else _real(t, w, *a, **k)
        monkeypatch.setattr(mod, "qdot", qdot)

    lp_r = {k: jnp.asarray(v) for k, v in lp.items()}
    wo = lp_r["wo"]
    out_r, nk_r, nv_r, (nks_r, nvs_r) = R_attn.decode_self_attention(
        jnp.asarray(x), lp_r, cfg, jnp.asarray(ck), jnp.asarray(cv),
        jnp.asarray(pos), policy=r_policy_for("bf16"),
        kv_scales=(jnp.asarray(ks), jnp.asarray(vs)))
    lp_t = {k: torch.from_numpy(v) for k, v in lp.items()}
    wo = lp_t["wo"]
    caches = [torch.from_numpy(a.copy()) for a in (ck, cv, ks, vs)]
    out_t, nk_t, nv_t, (nks_t, nvs_t) = T_attn.decode_self_attention(
        torch.from_numpy(x), lp_t, cfg, caches[0], caches[1],
        torch.from_numpy(pos), policy=policy_for("bf16"),
        kv_scales=(caches[2], caches[3]))
    for r, t in ((nk_r, nk_t), (nv_r, nv_t), (nks_r, nks_t),
                 (nvs_r, nvs_t)):
        np.testing.assert_array_equal(t.numpy(), np.asarray(r))
    out_r, out_t = np.asarray(out_r), out_t.numpy()
    assert out_t.dtype == np.float32
    rel = float(np.max(np.abs(out_t - out_r)) / np.max(np.abs(out_r)))
    print("int8-KV core vs model branch:", rel)
    assert rel <= KERNEL_TOL


def test_decode_attention_refuses_windows_only():
    """Per-slot positions, the int8 cache and a dynamic window on its plain
    route are ported; only the int8 kernel route refuses a window."""
    _, _, tmodel, tparams = _models("phi4-mini-3.8b", "bf16", False)
    cfg = tmodel.cfg
    x = torch.zeros((2, 1, cfg.d_model), dtype=torch.bfloat16)
    c8 = torch.zeros((2, 4, cfg.n_kv_heads, cfg.head_dim), dtype=torch.int8)
    sc = torch.zeros((2, 4, cfg.n_kv_heads))
    out = T_attn.decode_self_attention(
        x, tparams["layers"][0], cfg, c8, c8.clone(), torch.tensor([0, 3]),
        policy=policy_for("bf16"), kv_scales=(sc, sc.clone()))
    assert len(out) == 4 and tuple(out[0].shape) == (2, 1, cfg.d_model)
    out = T_attn.decode_self_attention(
        x, tparams["layers"][0], cfg, c8, c8.clone(), 0,
        policy=policy_for("bf16"), window=2, kv_scales=(sc, sc.clone()))
    assert len(out) == 4 and tuple(out[0].shape) == (2, 1, cfg.d_model)
    with pytest.raises(NotImplementedError, match="ROADMAP A.6"):
        T_attn.decode_self_attention(x, tparams["layers"][0], cfg, c8, c8, 0,
                                     policy=policy_for("bf16"), window=2,
                                     kv_scales=(sc, sc), impl="kernel")


# ------------------------------------------------------- flash attention

def _qkv(seed, b, h, sq, sk, d, dtype):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal((b, h, s, d)).astype(np.float32)
            for s in (sq, sk, sk)]
    jd = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    td = torch.bfloat16 if dtype == "bf16" else torch.float32
    return ([jnp.asarray(a, jd) for a in arrs],
            [torch.from_numpy(a).to(td) for a in arrs])


FLASH_CASES = [
    # (b, h, sq, sk, d, causal, window, dtype)
    (1, 2, 64, 64, 16, True, None, "f32"),
    (2, 3, 128, 128, 32, True, None, "f32"),
    (1, 2, 64, 64, 16, True, None, "bf16"),
    (2, 3, 128, 128, 32, True, None, "bf16"),
    (2, 2, 128, 128, 16, True, 16, "f32"),
    (2, 2, 128, 128, 16, True, 48, "f32"),
    (1, 2, 64, 64, 16, False, None, "f32"),
    (1, 2, 32, 96, 16, True, None, "f32"),
    (1, 2, 64, 128, 32, True, 48, "bf16"),
]


@pytest.mark.parametrize("b,h,sq,sk,d,causal,window,dtype", FLASH_CASES)
def test_flash_plain_matches_oracle_and_pallas(b, h, sq, sk, d, causal,
                                               window, dtype):
    jx, tt = _qkv(sq + sk + d, b, h, sq, sk, d, dtype)
    got = ops.flash_attention(*tt, causal=causal, window=window)
    assert got.dtype == tt[0].dtype and tuple(got.shape) == (b, h, sq, d)
    oracle = R_ref.flash_attention_ref(*jx, causal=causal, window=window)
    pallas = R_flash(*jx, causal=causal, window=window, bq=32, bk=32,
                     interpret=True)
    tol = TOL if dtype == "bf16" else KERNEL_TOL
    worst = []
    for want in (oracle, pallas):
        w = _f32(want)
        worst.append(float(np.max(np.abs(_f32(got) - w))))
        np.testing.assert_allclose(_f32(got), w, rtol=tol, atol=tol)
    print((b, h, sq, sk, d, causal, window, dtype), worst)


@pytest.mark.parametrize("sq,sk", [(77, 77), (13, 100), (100, 100)])
def test_flash_plain_ragged_lengths_match_oracle(sq, sk):
    """The port takes any lengths (the Pallas entry needs divisible ones):
    held to the oracle alone."""
    jx, tt = _qkv(sq * sk, 1, 2, sq, sk, 16, "f32")
    for causal, window in ((True, None), (False, None), (True, 24)):
        got = ops.flash_attention(*tt, causal=causal, window=window)
        want = R_ref.flash_attention_ref(*jx, causal=causal, window=window)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=KERNEL_TOL, atol=KERNEL_TOL)


def test_flash_checks_its_operands():
    _, tt = _qkv(0, 1, 2, 8, 8, 16, "f32")
    with pytest.raises(ValueError, match="CUDA tensors"):
        from repro_torch.kernels.flash_attention import flash_attention
        flash_attention(*tt)
    with pytest.raises(ValueError, match="window must be"):
        ops.flash_attention(*tt, window=0, impl="kernel")
    with pytest.raises(ValueError, match="float32 or bfloat16 alike"):
        ops.flash_attention(tt[0], tt[1].to(torch.bfloat16), tt[2],
                            impl="kernel")


def test_dense_attention_matches_reference():
    """The model's plain route against the reference's, layout (b, s, H,
    hd)."""
    rng = np.random.default_rng(4)
    q, k, v = (rng.standard_normal((2, s, 4, 16)).astype(np.float32)
               for s in (24, 40, 40))
    for causal, window in ((True, None), (True, 8), (False, None)):
        want = R_attn.dense_attention(jnp.asarray(q), jnp.asarray(k),
                                      jnp.asarray(v), causal=causal,
                                      window=window)
        got = T_attn.dense_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                                     causal=causal, window=window)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=KERNEL_TOL, atol=KERNEL_TOL)


# ------------------------------------------------- forward and decode

SEQ = 12
BATCH = 2


@pytest.mark.parametrize("arch,mode,quantize", CASES)
def test_forward_matches_reference(arch, mode, quantize):
    rmodel, rparams, tmodel, tparams = _models(arch, mode, quantize)
    cfg = tmodel.cfg
    tokens = np.random.default_rng(2).integers(0, cfg.vocab, (BATCH, SEQ))
    want, _ = jax.jit(lambda p, t: rmodel.forward(p, t, train=False))(
        rparams, jnp.asarray(tokens, jnp.int32))
    got, aux = tmodel.forward(tparams, torch.from_numpy(tokens))
    assert got.dtype == torch.bfloat16 and float(aux) == 0.0
    assert tuple(got.shape) == (BATCH, SEQ, cfg.vocab)
    err = float(np.max(np.abs(_f32(got) - _f32(want))))
    print(arch, mode, quantize, "forward logits", err)
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=TOL, atol=TOL)
    last, _ = tmodel.forward(tparams, torch.from_numpy(tokens),
                             last_only=True)
    assert torch.equal(last, got[:, -1:])


@pytest.mark.parametrize("arch,mode,quantize", CASES[:3])
@pytest.mark.parametrize("per_slot", [False, True])
def test_int8_kv_decode_matches_reference(arch, mode, quantize, per_slot):
    """Teacher-forced int8-KV decode, one position for the batch or one
    per slot (offsets 0, 2, 5), against the reference's ``decode_step``
    with ``init_cache(kv_quant=True)``."""
    rmodel, rparams, tmodel, tparams = _models(arch, mode, quantize)
    cfg = tmodel.cfg
    b, steps = 3, 6
    offs = np.array([0, 2, 5], np.int32) if per_slot else np.zeros(b, np.int32)
    S = steps + int(offs.max())
    tokens = np.random.default_rng(1).integers(0, cfg.vocab, (b, steps))
    rcache = rmodel.init_cache(b, S, kv_quant=True)
    tcache = tmodel.init_cache(b, S, kv_quant=True)
    assert set(tcache) == set(rcache) == {"k", "v", "k_scale", "v_scale"}
    decode = jax.jit(rmodel.decode_step)
    worst = {"logits": 0.0, "k": 0.0, "v": 0.0}
    for i in range(steps):
        tok = tokens[:, i:i + 1]
        if per_slot:
            rpos, tpos = jnp.asarray(offs + i), torch.from_numpy(offs + i)
        else:
            rpos, tpos = jnp.int32(i), i
        rlog, rcache = decode(rparams, rcache, jnp.asarray(tok, jnp.int32),
                              rpos)
        tlog, tcache = tmodel.decode_step(tparams, tcache,
                                          torch.from_numpy(tok), tpos)
        assert tcache["k"].dtype == torch.int8
        pairs = [("logits", _f32(rlog), _f32(tlog))]
        for name in ("k", "v"):
            r = np.asarray(rcache[name], np.float32) \
                * np.asarray(rcache[f"{name}_scale"])[..., None]
            t = (tcache[name].float()
                 * tcache[f"{name}_scale"][..., None]).numpy()
            pairs.append((name, r, t))
        for name, r, t in pairs:
            worst[name] = max(worst[name], float(np.max(np.abs(r - t))))
            np.testing.assert_allclose(t, r, rtol=TOL, atol=TOL,
                                       err_msg=f"{name} at step {i}")
    print(arch, mode, per_slot, worst)


@pytest.mark.parametrize("arch", ["starcoder2-7b", "phi4-mini-3.8b"])
def test_int8_kv_decode_equals_forward(arch):
    """The port's int8-KV decode replayed over 20 tokens against its own
    forward, as ``tests/test_perf_paths.py`` holds the reference."""
    _, _, tmodel, tparams = _models(arch, "bf16", False)
    cfg = tmodel.cfg
    s = 20
    toks = torch.from_numpy(
        np.random.default_rng(1).integers(0, cfg.vocab, (2, s)))
    full, _ = tmodel.forward(tparams, toks)
    caches = tmodel.init_cache(2, s, kv_quant=True)
    outs = []
    for i in range(s):
        lg, caches = tmodel.decode_step(tparams, caches, toks[:, i:i + 1], i)
        outs.append(lg[:, 0])
    dec = torch.stack(outs, 1).float()
    rel = float((dec - full.float()).abs().max() / full.float().abs().max())
    print(arch, "int8-KV decode vs forward", rel)
    assert rel < 5e-2


def test_prefill_fills_the_caches_decode_would():
    _, _, tmodel, tparams = _models("phi4-mini-3.8b", "w8a8", True)
    toks = torch.from_numpy(
        np.random.default_rng(3).integers(0, tmodel.cfg.vocab, (2, 6)))
    logits, caches = tmodel.prefill(tparams, toks, max_seq=9)
    full, _ = tmodel.forward(tparams, toks)
    assert torch.equal(logits, full)
    assert caches["k"].dtype == torch.bfloat16
    assert tuple(caches["k"].shape)[1:3] == (2, 9)
    want = tmodel.init_cache(2, 9)
    for i in range(6):
        _, want = tmodel.decode_step(tparams, want, toks[:, i:i + 1], i)
    assert torch.equal(caches["k"], want["k"])
    assert torch.equal(caches["v"], want["v"])
    assert not caches["k"][:, :, 6:].any()


def test_forward_cuda_refused_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    from repro_torch.configs import get_config
    from repro_torch.configs.base import reduced
    from repro_torch.models.model import Model
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Model(dataclasses.replace(reduced(get_config("phi4-mini-3.8b"))))
