"""The host-side plans of the port's redesigned kernels, on the CPU.

* The W8A8 planner (``kernels/w8a8_matmul.plan``): the split-k ``dp4a``
  regime at decode, with at least 264 blocks (two per SM of an H100) on
  every phi4-mini projection shape; the tensor-core regime from
  ``TC_MIN_M`` on; splits that cover k with none empty; the workspace
  sizes it states; the persistent zeroed workspace.
* The bf16 flash kernel's rounding (``csrc/flash_attention_tc.cu``): the
  tensor cores take P in bf16 per 64-key tile, ``l`` sums the rounded
  values, the softmax runs in base 2.  A plain-torch emulation of that
  arithmetic, with the kernel's tile order and skips and P split into
  two bf16 parts (hi + lo), is held to the JAX reference's oracle and
  its Pallas kernel in interpret mode at the bf16 bound of 2e-2
  (``tests/test_kernels.py``).  It documents the rounding argument; the
  card tests hold the kernel itself to the same bound at every head
  dim.

Inputs are drawn with numpy from a seed and handed to both packages.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as R_ref
from repro.kernels.flash_attention import flash_attention as R_flash
from repro_torch.kernels import flash_attention as T_flash
from repro_torch.kernels import w8a8_matmul as W8

# phi4-mini-3.8b's projections: (k, n) of q/o, k/v, gate/up, down
PHI4_PROJ = ((3072, 3072), (3072, 1024), (3072, 8192), (8192, 3072))
H100_SMS = 132
BF16_TOL = 2e-2

# ------------------------------------------------------------ W8A8 plans


def _grid(p, m, n):
    """(output tiles, blocks) of a plan: row_tile x 128 outputs a block
    (the dp4a blocks' 128 columns, the tensor cores' 128 x 128)."""
    cols = W8.TC_TILE if p.regime == "tc" else W8.DP4A_COLS
    tiles = math.ceil(m / p.row_tile) * math.ceil(n / cols)
    return tiles, tiles * p.splits


@pytest.mark.parametrize("k,n", PHI4_PROJ)
@pytest.mark.parametrize("m", [1, 4, 8, 16])
def test_plan_splits_k_on_the_phi4_decode_shapes(m, k, n):
    p = W8.plan(m, k, n)
    assert p.regime == "dp4a"
    assert p.splits > 1
    assert _grid(p, m, n)[1] >= 2 * H100_SMS


@pytest.mark.parametrize("m", [W8.TC_MIN_M, 64, 700, 4096])
def test_plan_takes_the_tensor_cores_from_the_threshold(m):
    for k, n in PHI4_PROJ:
        p = W8.plan(m, k, n)
        assert p.regime == "tc" and p.splits == 1
        assert p.workspace == 0
        assert p.row_tile == 128
    assert W8.plan(W8.TC_MIN_M - 1, 3072, 3072).regime == "dp4a"


@pytest.mark.parametrize("seed", range(8))
def test_plan_splits_cover_k_and_state_their_workspace(seed):
    rng = np.random.default_rng(seed)
    for _ in range(50):
        m = int(rng.integers(1, W8.TC_MIN_M))
        k = int(rng.integers(1, 20000))
        n = int(rng.integers(1, 9000))
        p = W8.plan(m, k, n)
        assert p.regime == "dp4a"
        assert p.row_tile == (4 if m <= 4 else 8 if m <= 8 else 16)
        tiles, blocks = _grid(p, m, n)
        nq = math.ceil(k / 4)                  # k in quads of 4
        per = math.ceil(nq / p.splits)
        # every split walks `per` quads but the last, which is not empty
        assert (p.splits - 1) * per < nq <= p.splits * per
        # the target met unless k is too short to split that far
        assert (blocks >= W8.SPLIT_TARGET_BLOCKS
                or nq < 2 * W8.SPLIT_MIN_QUADS * math.ceil(
                    W8.SPLIT_TARGET_BLOCKS / tiles))
        assert p.splits == 1 or per >= W8.SPLIT_MIN_QUADS // 2
        # m x n int32 sums, then one arrival counter a tile
        assert p.workspace == (m * n + tiles if p.splits > 1 else 0)


def test_plan_never_splits_what_fills_the_card():
    p = W8.plan(4, 3072, 128 * 2 * H100_SMS)
    assert p.splits == 1 and p.workspace == 0


def test_workspace_persists_zeroed_and_grows():
    from repro_torch.kernels import _workspace as WS
    dev = torch.device("cpu")
    key = (dev, None)              # a CPU buffer has no stream
    WS._WORKSPACE.pop(key, None)
    try:
        a = W8.workspace(dev, 10)
        assert WS._WORKSPACE[key] is a
        assert a.dtype == torch.int32 and a.numel() >= 10
        assert not a.any()
        assert W8.workspace(dev, a.numel()) is a
        b = W8.workspace(dev, a.numel() + 1)
        assert b.numel() > a.numel() and not b.any()
    finally:
        WS._WORKSPACE.pop(key, None)


def test_the_wrapper_refuses_cpu_tensors_with_its_counters_unmoved():
    x = torch.zeros((4, 64), dtype=torch.int8)
    w = torch.zeros((64, 32), dtype=torch.int8)
    before = (W8.launches, W8.launches_dp4a, W8.launches_tc)
    with pytest.raises(ValueError, match="CUDA tensors"):
        W8.w8a8_matmul(x, w, torch.ones(()), torch.ones(32))
    assert (W8.launches, W8.launches_dp4a, W8.launches_tc) == before


# -------------------------------------------- flash: P rounded to bf16

BQ, BK = 128, 64          # the kernel's q rows and keys a tile


def flash_bf16_emulation(q, k, v, *, causal=True, window=None,
                         round_p=True):
    """The tensor-core kernel's arithmetic in plain torch: q, k, v
    ``(b, h, s, d)`` -> out in q's dtype.  Per 128-row q tile, the key tiles it
    visits in order; logits in float32 scaled by ``d^-0.5 log2(e)``,
    masked to -1e30; running max ``m``, ``alpha = 2^(m_old - m_new)``;
    ``p = 2^(x - m)`` rounded to bf16 (0 past sk), ``l`` the sum of the
    rounded ``p``; ``acc += p @ v`` in float32; out ``acc / max(l,
    1e-30)``.  ``round_p``: p as the sum of two bf16 values (``hi =
    bf16(p)``, ``lo = bf16(p - hi)``), else kept in float32."""
    b, h, sq, d = q.shape
    sk = k.shape[2]
    scale2 = float(np.float32(d ** -0.5) * np.float32(math.log2(math.e)))
    qf, kf, vf = (t.to(torch.float32) for t in (q, k, v))
    out = torch.empty((b, h, sq, d), dtype=torch.float32)
    n_kt = -(-sk // BK)
    for q0 in range(0, sq, BQ):
        rows = slice(q0, min(q0 + BQ, sq))
        q_off = q0 + sk - sq
        qi = torch.arange(rows.start, rows.stop)[:, None] + (sk - sq)
        kt_end, kt_begin = n_kt, 0
        if causal and q_off + BQ - 1 < n_kt * BK:
            kt_end = max(0, (q_off + BQ - 1) // BK + 1)
        if window is not None and q_off - window + 1 > 0:
            kt_begin = min(n_kt, (q_off - window + 1) // BK)
        nr = rows.stop - rows.start
        m = torch.full((b, h, nr, 1), -1e30)
        l = torch.zeros((b, h, nr, 1))
        acc = torch.zeros((b, h, nr, d))
        for kt in range(kt_begin, kt_end):
            keys = slice(kt * BK, min(kt * BK + BK, sk))
            ki = torch.arange(keys.start, keys.stop)[None, :]
            s = qf[:, :, rows] @ kf[:, :, keys].transpose(-1, -2) * scale2
            keep = torch.ones_like(ki - qi, dtype=torch.bool)
            if causal:
                keep &= ki <= qi
            if window is not None:
                keep &= ki > qi - window
            s = torch.where(keep, s, torch.tensor(-1e30))
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            alpha = torch.exp2(m - m_new)
            p = torch.exp2(s - m_new)
            if round_p:
                hi = p.to(torch.bfloat16).to(torch.float32)
                p = hi + (p - hi).to(torch.bfloat16).to(torch.float32)
            l = l * alpha + p.sum(-1, keepdim=True)
            acc = acc * alpha + p @ vf[:, :, keys]
            m = m_new
        out[:, :, rows] = acc / l.clamp_min(1e-30)
    return out.to(q.dtype)


def _qkv(seed, b, h, sq, sk, d):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal((b, h, s, d)).astype(np.float32)
            for s in (sq, sk, sk)]
    return ([jnp.asarray(a, jnp.bfloat16) for a in arrs],
            [torch.from_numpy(a).to(torch.bfloat16) for a in arrs])


def _f32(x):
    return np.asarray(jnp.asarray(x, jnp.float32)) if not isinstance(
        x, torch.Tensor) else x.to(torch.float32).numpy()


@pytest.mark.parametrize("b,h,sq,sk,d,causal,window", [
    (1, 2, 256, 256, 64, True, None),
    (1, 2, 256, 256, 32, True, 48),
    (1, 2, 128, 256, 64, True, None),
    (1, 2, 128, 128, 16, False, None),
    (1, 1, 256, 256, 128, True, 100),
])
def test_bf16_rounded_p_stays_within_the_bf16_bound(b, h, sq, sk, d, causal,
                                                     window):
    jx, tt = _qkv(sq + sk + d, b, h, sq, sk, d)
    got = _f32(flash_bf16_emulation(*tt, causal=causal, window=window))
    oracle = _f32(R_ref.flash_attention_ref(*jx, causal=causal,
                                            window=window))
    pallas = _f32(R_flash(*jx, causal=causal, window=window, bq=64, bk=64,
                          interpret=True))
    worst = []
    for want in (oracle, pallas):
        worst.append(float(np.max(np.abs(got - want))))
        np.testing.assert_allclose(got, want, rtol=BF16_TOL, atol=BF16_TOL)
    print((b, h, sq, sk, d, causal, window), worst)


def test_the_emulation_is_the_plain_softmax_without_the_rounding():
    """With P kept in float32 the same tile order gives the plain
    version's attention: the rounding of P is the only change."""
    _, tt = _qkv(7, 1, 2, 256, 256, 64)
    q, k, v = (t.to(torch.float32) for t in tt)
    want = T_flash.flash_attention_ref(q, k, v, causal=True, window=40)
    got = flash_bf16_emulation(q, k, v, causal=True, window=40,
                               round_p=False)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5)


def test_flash_counts_each_route():
    assert {"launches", "launches_tc", "launches_f32"} <= set(vars(T_flash))
    q = torch.zeros((1, 1, 4, 16), dtype=torch.bfloat16)
    before = (T_flash.launches, T_flash.launches_tc, T_flash.launches_f32)
    with pytest.raises(ValueError, match="CUDA tensors"):
        T_flash.flash_attention(q, q, q)
    assert (T_flash.launches, T_flash.launches_tc,
            T_flash.launches_f32) == before
