"""Flash attention's decode regime (``csrc/flash_decode.cuh``) on the CPU:
its plain version on kv heads that divide the q heads, the split-and-merge
order of the kernel emulated in torch at the planner's splits, the
planner, the refusals, the routing of ``attention.attend`` and the op
counter's view of a vlm decode step.  The kernel itself runs only on the
card (``tests/test_torch_cuda.py``, ``chip_smoke.py``'s ``flash_decode``
phase).

Bounds, with the maxima measured on the CPU (torch 2.13, jax 0.9.0;
``pytest -s`` prints them):

* the plain version on ``kvh`` heads against itself on the kv heads
  repeated to ``h``: bit for bit (it repeats them itself);
* against the reference's oracle ``ref.flash_attention_ref`` on the
  repeated operands (numpy inputs from a seed): ``rtol = atol = 1e-6`` in
  float32 (measured 2.0e-7 at |out| <= 0.15 over 1601 keys), 2e-2 in bf16
  (the bf16 bound of ``tests/test_torch_attention``);
* the emulated split-and-merge order against the plain version: 1e-6 of
  max|out| in float32, rows with no live key included (the mean of v).
"""

import dataclasses
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as R_ref
from repro_torch.configs import get_config
from repro_torch.configs.base import reduced
from repro_torch.core import op_analysis as OA
from repro_torch.kernels import flash_attention as F
from repro_torch.kernels import ops
from repro_torch.models import attention as A
from repro_torch.models.model import Model

F32_TOL = 1e-6
BF16_TOL = 2e-2
MASKS = ((False, None), (True, None), (True, 5), (False, 9))


def _np_qkv(seed, b, h, kvh, sq, sk, d):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for shape in
            ((b, h, sq, d), (b, kvh, sk, d), (b, kvh, sk, d))]


def _torch(arrs, dtype):
    return [torch.from_numpy(a).to(dtype) for a in arrs]


# ---------------------------------------------------- the plain version

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rep", [1, 2, 8])
@pytest.mark.parametrize("sq", [1, 3, 8])
def test_gqa_plain_is_the_plain_version_on_repeated_operands(dtype, rep,
                                                             sq):
    """On k, v at kvh heads the plain version equals itself on the kv
    heads repeated to h (q head g * rep + j reads kv head g), bit for bit,
    for ragged key counts and every mask."""
    kvh = 2
    for sk in (1, 7, 37):
        for causal, window in MASKS:
            q, k, v = _torch(_np_qkv(sk + rep, 2, kvh * rep, kvh, sq, sk,
                                     16), dtype)
            got = F.flash_attention_ref(q, k, v, causal=causal,
                                        window=window)
            want = F.flash_attention_ref(
                q, torch.repeat_interleave(k, rep, dim=1),
                torch.repeat_interleave(v, rep, dim=1), causal=causal,
                window=window)
            assert got.dtype == dtype and tuple(got.shape) == tuple(q.shape)
            assert torch.equal(got, want), (sk, causal, window)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("rep", [1, 2, 8])
@pytest.mark.parametrize("sq,sk", [(1, 1601), (1, 7), (4, 100), (8, 64)])
def test_gqa_plain_matches_the_reference_oracle(dtype, rep, sq, sk):
    """Against ``ref.flash_attention_ref`` on the kv heads repeated by
    numpy: ``rtol = atol = 1e-6`` in float32, 2e-2 in bf16."""
    b, kvh, d = 2, 2, 64
    arrs = _np_qkv(sq * 7 + sk + rep, b, kvh * rep, kvh, sq, sk, d)
    jd = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    td = torch.bfloat16 if dtype == "bf16" else torch.float32
    rep_arrs = [arrs[0]] + [np.repeat(a, rep, axis=1) for a in arrs[1:]]
    for causal, window in MASKS:
        want = np.asarray(R_ref.flash_attention_ref(
            *[jnp.asarray(a, jd) for a in rep_arrs], causal=causal,
            window=window)).astype(np.float32)
        got = F.flash_attention_ref(*_torch(arrs, td), causal=causal,
                                    window=window).float().numpy()
        err = float(np.abs(got - want).max())
        tol = F32_TOL if dtype == "f32" else BF16_TOL
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol)
        print(dtype, rep, sq, sk, causal, window, err)


def test_a_row_with_no_live_key_takes_the_mean_of_v():
    """Causal with sq > sk: rows whose position is before every key see
    only -1e30 logits, so each key weighs 1, as in a dense softmax of
    -1e30 (the reference's oracle gives NaN there); the other rows are
    the oracle's."""
    arrs = _np_qkv(3, 1, 4, 2, 6, 3, 16)
    q, k, v = _torch(arrs, torch.float32)
    got = F.flash_attention_ref(q, k, v, causal=True)
    mean = torch.repeat_interleave(v, 2, dim=1).mean(dim=2)
    torch.testing.assert_close(got[:, :, :3], mean[:, :, None].expand(
        -1, -1, 3, -1), rtol=1e-6, atol=1e-6)
    want = np.asarray(R_ref.flash_attention_ref(
        *[jnp.asarray(a) for a in [arrs[0]] + [np.repeat(x, 2, axis=1)
                                               for x in arrs[1:]]],
        causal=True))
    assert np.isnan(want[:, :, :3]).all()
    np.testing.assert_allclose(got[:, :, 3:].numpy(), want[:, :, 3:],
                               rtol=F32_TOL, atol=F32_TOL)


# -------------------------------------- the kernel's order, emulated

def _chunk(d: int, dtype) -> int:
    """Keys a lane group scores before one rescale (``Cfg::C``)."""
    words = d * dtype.itemsize // 16
    w = words // min(8, words)
    return 1 if w >= 4 else 4 // w


def decode_split_emulation(q, k, v, *, causal, window, scale=None,
                           kernel_dtype=None):
    """The decode kernel's order in plain float32 torch, at
    :func:`F.decode_plan`'s layout: per (batch row, kv head) the rows
    ``r = i * rep + j``; the keys ``[key_lo, sk)`` in splits; in a split,
    slice ``s`` takes every ``slices``-th key from ``s`` and keeps its
    own online softmax in base 2, ``C`` keys scored before one rescale
    (masked logits -1e30, keys past the split left out); the slices'
    partials merged with weights ``2^(m - M)``, then the splits' the same
    way; out = acc / max(l, 1e-30).  ``kernel_dtype``: the operands'
    dtype the kernel would be built for (the plan and C depend on it)."""
    b, h, sq, d = q.shape
    kvh, sk = k.shape[1], k.shape[2]
    rep = h // kvh
    dt = kernel_dtype or q.dtype
    p = F.decode_plan(b, h, kvh, sq, sk, d, dt, causal=causal,
                      window=window)
    C = _chunk(d, dt)
    sl = float(F._scale(d, scale)) * 1.4426950408889634
    qf = q.float().reshape(b, kvh, rep, sq, d).permute(0, 1, 3, 2, 4) \
        .reshape(b * kvh, sq * rep, d)          # rows r = i * rep + j
    kf = k.float().reshape(b * kvh, sk, d)
    vf = v.float().reshape(b * kvh, sk, d)
    R = sq * rep
    qi = torch.arange(R) // rep + sk - sq
    ninf = float("-inf")
    parts = []
    for sp in range(p.splits):
        k0 = p.key_lo + sp * p.split_keys
        n = min(sk - k0, p.split_keys)
        S = p.slices
        nt = -(-n // S)
        at = torch.arange(nt)[:, None] * S + torch.arange(S)[None, :]
        ok = at < n                                        # (nt, S)
        key = k0 + at.clamp(max=n - 1)
        m = torch.full((b * kvh, S, R), ninf)
        l = torch.zeros((b * kvh, S, R))
        acc = torch.zeros((b * kvh, S, R, d))
        for t0 in range(0, nt, C):
            kk = kf[:, key[t0:t0 + C]]                     # (g, c, S, d)
            vv = vf[:, key[t0:t0 + C]]
            s = torch.einsum("grd,gcsd->gscr", qf, kk) * sl
            keys = key[t0:t0 + C].T[None, :, :, None]      # (1, S, c, 1)
            live = torch.ones_like(s, dtype=torch.bool)
            if causal:
                live &= keys <= qi
            if window is not None:
                live &= keys > qi - window
            s = torch.where(live, s, torch.tensor(-1e30))
            s = torch.where(ok[t0:t0 + C].T[None, :, :, None], s,
                            torch.tensor(ninf))
            mc = s.amax(dim=2)
            up = mc > m
            alpha = torch.where(m == ninf, torch.zeros_like(m),
                                torch.exp2(m - mc))
            l = torch.where(up, l * alpha, l)
            acc = torch.where(up[..., None], acc * alpha[..., None], acc)
            m = torch.where(up, mc, m)
            pr = torch.where(s == ninf, torch.zeros_like(s),
                             torch.exp2(s - m[:, :, None, :]))
            for c in range(pr.shape[2]):
                l = l + pr[:, :, c]
            acc = acc + torch.einsum("gscr,gcsd->gsrd", pr, vv)
        M = m.amax(dim=1)
        w = torch.where(m == ninf, torch.zeros_like(m),
                        torch.exp2(m - M[:, None]))
        parts.append((M, (w * l).sum(dim=1),
                      (w[..., None] * acc).sum(dim=1)))
    M = torch.stack([pt[0] for pt in parts], dim=1)
    top = M.amax(dim=1)
    w = torch.exp2(M - top[:, None])
    lsum = (w * torch.stack([pt[1] for pt in parts], dim=1)).sum(dim=1)
    acc = (w[..., None] * torch.stack([pt[2] for pt in parts],
                                      dim=1)).sum(dim=1)
    out = acc / lsum.clamp_min(1e-30)[..., None]           # (g, R, d)
    return out.reshape(b, kvh, sq, rep, d).permute(0, 1, 3, 2, 4) \
        .reshape(b, h, sq, d)


EMULATED = [  # (b, h, kvh, sq, sk, d, causal, window, kernel dtype)
    (4, 64, 8, 1, 1601, 128, False, None, torch.bfloat16),   # llama cross
    (4, 16, 16, 1, 1500, 64, False, None, torch.bfloat16),   # whisper cross
    (2, 16, 2, 8, 1601, 128, False, None, torch.bfloat16),
    (2, 8, 1, 3, 4099, 256, True, 300, torch.float32),
    (3, 6, 3, 16, 700, 16, True, None, torch.float32),
    (2, 8, 2, 9, 3, 64, True, None, torch.float32),          # no live key
    (1, 4, 2, 5, 1, 32, False, 2, torch.bfloat16),
]


@pytest.mark.parametrize("b,h,kvh,sq,sk,d,causal,window,kdt", EMULATED)
def test_split_and_merge_order_matches_the_plain_version(b, h, kvh, sq, sk,
                                                         d, causal, window,
                                                         kdt):
    """The emulated order at the planner's splits, slices and chunks
    within 1e-6 of max|out| of the plain version (float32 operands)."""
    q, k, v = _torch(_np_qkv(sk + sq + d, b, h, kvh, sq, sk, d),
                     torch.float32)
    got = decode_split_emulation(q, k, v, causal=causal, window=window,
                                 kernel_dtype=kdt)
    want = F.flash_attention_ref(q, k, v, causal=causal, window=window)
    err = float((got - want).abs().max())
    print((b, h, kvh, sq, sk, d, causal, window),
          F.decode_plan(b, h, kvh, sq, sk, d, kdt, causal=causal,
                        window=window), err)
    assert torch.isfinite(got).all()
    assert err <= F32_TOL * float(want.abs().max()), err


@pytest.mark.parametrize("shape,dtype,want", [
    ((4, 64, 8, 1, 1601, 128), torch.bfloat16,
     dict(rt=2, passes=4, slices=8, key_lo=0, split_keys=201, splits=8,
          blocks=256, scratch=32 * 8 * 8 * 130, workspace=32)),
    ((4, 16, 16, 1, 1500, 64), torch.bfloat16,
     dict(rt=1, passes=1, slices=32, key_lo=0, split_keys=375, splits=4,
          blocks=256, scratch=64 * 4 * 1 * 66, workspace=64)),
    ((4, 64, 8, 1, 1601, 128), torch.float32,
     dict(rt=2, passes=4, slices=8, key_lo=0, split_keys=201, splits=8,
          blocks=256, scratch=32 * 8 * 8 * 130, workspace=32)),
])
def test_the_planner_at_the_cross_decode_shapes(shape, dtype, want):
    """llama-3.2-vision's and whisper's decode cross-attention: 256
    blocks each (one a (b, kv head) gave 32 and 64), two a SM of the 132,
    each split reading at least 64 keys."""
    got = F.decode_plan(*shape, dtype, causal=False, window=None)
    assert got._asdict() == want


def test_the_planner_splits_only_the_keys_a_row_can_see():
    p = F.decode_plan(1, 8, 2, 4, 5000, 64, torch.bfloat16, causal=True,
                      window=100)
    assert p.key_lo == 5000 - 4 - 100 + 1
    assert p.key_lo + p.split_keys * (p.splits - 1) < 5000 \
        <= p.key_lo + p.split_keys * p.splits
    # a row before every key (causal, sq > sk) keeps every key
    assert F.decode_plan(1, 8, 2, 9, 3, 64, torch.bfloat16, causal=True,
                         window=2).key_lo == 0
    # a long row block: one split, read at least 4x its partial
    big = F.decode_plan(4, 64, 8, 64, 1601, 128, torch.bfloat16,
                        causal=False, window=None)
    assert big.splits == 1 and big.scratch == 0 and big.workspace == 0


# ------------------------------------------------------ the refusals

def test_refusals():
    q = torch.zeros((1, 6, 1, 16))
    k = torch.zeros((1, 4, 9, 16))
    with pytest.raises(ValueError, match="kvh dividing"):
        F.flash_attention(q, k, k)
    with pytest.raises(ValueError, match="kvh dividing"):
        F.flash_attention_ref(q, k, k)
    k = torch.zeros((1, 3, 9, 16))
    with pytest.raises(ValueError, match="CUDA tensors"):
        F.flash_attention(q, k, k, regime="decode")
    for regime in ("fast", "Decode"):
        with pytest.raises(ValueError, match="regime must be one of"):
            ops.flash_attention(q, k, k, regime=regime)
        with pytest.raises(ValueError, match="regime must be one of"):
            F.regime_for(1, regime)
    assert F.regime_for(1) == F.regime_for(F.DECODE_MAX_SQ) == "decode"
    assert F.regime_for(F.DECODE_MAX_SQ + 1) == "tile"
    assert F.regime_for(1, "tile") == "tile"
    assert "launches_decode" in vars(F)


@pytest.mark.parametrize("name", ["flash_decode", "flash_decode_f32"])
def test_decode_libraries_are_bound_and_hashed_with_their_header(
        name, monkeypatch, tmp_path):
    """Both decode libraries bind the one C entry (24 arguments: the plan's
    key_lo, split_keys, rt and slices among them, no dtype flag) and
    change their name when the shared ``flash_decode.cuh`` changes."""
    import shutil
    from repro_torch.kernels import _build
    sig = _build.SIGNATURES[name]
    assert len(sig["qappa_flash_decode"][1]) == 24
    assert "qappa_error_string" in sig
    before = _build.library_path(name)
    src = tmp_path / "csrc"
    shutil.copytree(_build.SOURCE_DIR, src)
    monkeypatch.setattr(_build, "SOURCE_DIR", src)
    assert _build.library_path(name).name == before.name
    with open(src / "flash_decode.cuh", "a") as f:
        f.write("// edited\n")
    assert _build.library_path(name).name != before.name


def test_cost_counts_k_v_at_their_heads():
    flops, nbytes, cls = F.cost(4, 64, 1, 1601, 128, causal=False,
                                window=None, dtype=torch.bfloat16, kvh=8)
    assert flops == 4.0 * 128 * 4 * 64 * 1601 and cls == "bf16"
    assert nbytes == 2 * (1 * 64 + 1601 * 8) * 4 * 128 * 2
    assert nbytes / 3.35e12 * 1e3 == pytest.approx(0.00787, rel=1e-3)
    assert F.cost(4, 64, 1, 1601, 128, causal=False, window=None,
                  dtype=torch.bfloat16)[1] == 2 * (1 + 1601) * 4 * 64 * 128 * 2


# -------------------------------------------------- the model's route

@pytest.fixture
def kernel_stubs(monkeypatch):
    """``"auto"`` finds every tensor on a kernel device; the flash wrapper
    records the regime the route hands it and each operand's layout, and
    returns its plain version."""
    seen = []

    def stub(q, k, v, *, causal=True, window=None, scale=None,
             regime=None):
        seen.append({"regime": F.regime_for(q.shape[2], regime),
                     "kvh": k.shape[1], "k_contiguous": k.is_contiguous(),
                     "k_stride": k.stride()})
        return F.flash_attention_ref(q, k, v, causal=causal, window=window,
                                     scale=scale)
    monkeypatch.setattr(ops, "on_card", lambda x: True)
    monkeypatch.setattr(F, "flash_attention", stub)
    return seen


@pytest.mark.parametrize("regime", [None, "tile", "decode"])
@pytest.mark.parametrize("sq", [1, 8, 40])
def test_attend_hands_the_decode_regime_the_caches_in_place(kernel_stubs,
                                                            sq, regime):
    """The route hands the wrapper q, k and v as strided (b, heads, s, d)
    views of the model's (b, s, heads, d) tensors, k and v at their kv
    heads (no repeat, no copy), with ``regime`` passed on: the wrapper
    picks the regime (the decode regime up to ``DECODE_MAX_SQ`` q rows)
    where none is given.  Each equals the plain route within 1e-6."""
    rng = np.random.default_rng(sq)
    q = torch.from_numpy(rng.standard_normal((2, sq, 16, 32))
                         .astype(np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((2, 50, 2, 32))
                             .astype(np.float32)) for _ in range(2))
    got = A.attend(q, k, v, causal=False, impl="kernel", regime=regime)
    want = A.attend(q, k, v, causal=False, impl="ref", regime=regime)
    assert float((got - want).abs().max()) <= 1e-6
    (call,) = kernel_stubs
    assert call == {"regime": regime or ("decode" if sq <= F.DECODE_MAX_SQ
                                         else "tile"),
                    "kvh": 2, "k_contiguous": False,
                    "k_stride": (50 * 2 * 32, 32, 2 * 32, 1)}
    with pytest.raises(ValueError, match="regime must be one of"):
        A.attend(q, k, v, causal=False, impl="ref", regime="split")


def test_a_vlm_decode_step_counts_one_flash_call_a_cross_layer(
        monkeypatch):
    """Under fake tensors a reduced vlm decode step (rep 8 on its cross
    layers) counts one flash call per cross layer, its bytes k and v at
    kvh heads, and no repeat of the context caches outside the kernel's
    scope."""
    cfg = dataclasses.replace(reduced(get_config("llama-3.2-vision-90b")),
                              n_heads=8, n_kv_heads=1, quant="w8a8")
    outside = []
    real = A._broadcast_kv

    def watched(t, n_heads):
        counter = OA.active()
        if counter is not None and counter._scopes == 0 \
                and n_heads != t.shape[2]:
            outside.append(tuple(t.shape))
        return real(t, n_heads)
    monkeypatch.setattr(A, "_broadcast_kv", watched)
    with torch._subclasses.fake_tensor.FakeTensorMode():
        model = Model(cfg, device="cpu")
        params = model.init(torch.Generator("cpu").manual_seed(3),
                            quantize=True)
        caches = model.init_cache(2, 12)
        tok = torch.zeros((2, 1), dtype=torch.int64)
        with torch.no_grad():
            _, st = OA.analyze_step(model.decode_step, params, caches, tok,
                                    5)
    n_cross = cfg.n_layers // cfg.cross_attn_every
    rec = st.by_kernel["flash_attention"]
    assert rec["calls"] == n_cross >= 1
    sc, hd = cfg.n_ctx_tokens, cfg.head_dim
    _, nbytes, _ = F.cost(2, 8, 1, sc, hd, causal=False, window=None,
                          dtype=torch.bfloat16, kvh=1)
    assert rec["bytes"] == n_cross * nbytes
    assert nbytes == 2 * (8 + sc) * 2 * hd * 2
    assert outside == []
    assert math.isfinite(st.bytes_accessed)
