"""The arithmetic of the two kernels redesigned around splits, on the CPU.

* Float32 flash attention on the TF32 tensor cores
  (``csrc/flash_attention.cu``): each operand split into a TF32 hi part
  (round to nearest, ties away, by bit arithmetic on the float32) and a
  TF32 lo part (the exact rest, rounded again), and each product taken
  as ``a_lo . b_hi + a_hi . b_lo + a_hi . b_hi`` (3xTF32), in the
  kernel's tile order: QK^T in groups of 4 steps of 8 along d, PV per
  key tile, each added in float32.  A plain-torch emulation stays within
  the float32 bound of 1e-5 (``tests/test_kernels.py``) of the JAX
  reference's oracle and of its Pallas kernel in interpret mode; one TF32
  product alone does not, so the split is what keeps the bound.  The
  card tests hold the kernel itself to the same bound at every head dim.
* Decode attention split across S (``csrc/w8a8_decode.cu``): the planner
  ``kernels/w8a8_decode.plan`` and an emulation of the kernel's
  cross-split order (split maxima, float64 ``l`` partials summed in split
  order, the probability scale of a one-block call as a maximum over the
  splits, int32 partial PV sums, float32 terms in block order), equal bit
  for bit to the plain version and within 1e-5 of the JAX oracle.

Inputs are drawn with numpy from a seed and handed to both packages.
Measured maxima (CPU, torch 2.13, jax 0.9.0) with ``pytest -s``.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as R_ref
from repro.kernels.flash_attention import flash_attention as R_flash
from repro_torch.kernels import flash_attention as T_flash
from repro_torch.kernels import w8a8_decode as D

F32_TOL = 1e-5
H100_SMS = 132

# ----------------------------------------------------- float32 flash, 3xTF32


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32 (10 explicit mantissa bits), to nearest
    with ties away from zero: half a TF32 ulp added to the bits, the 13
    low bits cleared (as the kernel does, and cvt.rna.tf32.f32)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split_tf32(x: torch.Tensor):
    hi = tf32_rna(x)
    return hi, tf32_rna(x - hi)


def product(a: torch.Tensor, b: torch.Tensor, mode: str) -> torch.Tensor:
    """a @ b: "3xtf32", three products on split operands; "tf32", one on
    the rounded operands; "float32", the float32 product."""
    if mode == "float32":
        return a @ b
    a_hi, a_lo = split_tf32(a)
    b_hi, b_lo = split_tf32(b)
    if mode == "tf32":
        return a_hi @ b_hi
    return a_lo @ b_hi + a_hi @ b_lo + a_hi @ b_hi


def tile(d: int) -> tuple[int, int, int]:
    """(BQ, BK, KG) of the kernel at head dim d."""
    bq = 64 if d == 256 else 128
    bk = 16 if d == 256 else 32 if d == 128 else 64
    return bq, bk, min(d // 8, 4)


def flash_3xtf32_emulation(q, k, v, *, causal=True, window=None,
                           mode="3xtf32"):
    """The float32 kernel's arithmetic in plain torch: q, k, v float32
    ``(b, h, s, d)``.  Per BQ-row q tile, the key tiles it visits in order;
    logits summed over groups of KG steps of 8 along d (each group's
    products from 0, the groups added in float32), scaled by ``d^-0.5``,
    masked to -1e30; running max, ``alpha = exp(m_old - m_new)``,
    ``p = exp(s - m)`` (0 past sk), ``l`` the float32 sum of p; the tile's
    PV product added to ``acc * alpha``; out ``acc / max(l, 1e-30)``."""
    b, h, sq, d = q.shape
    sk = k.shape[2]
    bq, bk, kg = tile(d)
    scale = float(d) ** -0.5
    out = torch.empty_like(q)
    n_kt = -(-sk // bk)
    for q0 in range(0, sq, bq):
        rows = slice(q0, min(q0 + bq, sq))
        q_off = q0 + sk - sq
        qi = torch.arange(rows.start, rows.stop)[:, None] + (sk - sq)
        kt_end, kt_begin = n_kt, 0
        if causal and q_off + bq - 1 < n_kt * bk:
            kt_end = max(0, (q_off + bq - 1) // bk + 1)
        if window is not None and q_off - window + 1 > 0:
            kt_begin = min(n_kt, (q_off - window + 1) // bk)
        nr = rows.stop - rows.start
        m = torch.full((b, h, nr, 1), -1e30)
        l = torch.zeros((b, h, nr, 1))
        acc = torch.zeros((b, h, nr, d))
        for kt in range(kt_begin, kt_end):
            keys = slice(kt * bk, min(kt * bk + bk, sk))
            ki = torch.arange(keys.start, keys.stop)[None, :]
            s = torch.zeros((b, h, nr, keys.stop - keys.start))
            for c0 in range(0, d, 8 * kg):
                cols = slice(c0, c0 + 8 * kg)
                s = s + product(q[:, :, rows, cols],
                                k[:, :, keys, cols].transpose(-1, -2), mode)
            keep = torch.ones_like(ki - qi, dtype=torch.bool)
            if causal:
                keep &= ki <= qi
            if window is not None:
                keep &= ki > qi - window
            s = torch.where(keep, s * scale, torch.tensor(-1e30))
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            alpha = torch.exp(m - m_new)
            p = torch.exp(s - m_new)
            l = l * alpha + p.sum(-1, keepdim=True)
            acc = acc * alpha + product(p, v[:, :, keys], mode)
            m = m_new
        out[:, :, rows] = acc / l.clamp_min(1e-30)
    return out


def _qkv(seed, b, h, sq, sk, d):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, h, s, d)).astype(np.float32)
            for s in (sq, sk, sk)]


FLASH_CASES = [  # (b, h, sq, sk, d, causal, window), Pallas-divisible
    (1, 2, 256, 256, 16, True, None),
    (1, 2, 128, 256, 64, True, None),
    (1, 2, 256, 256, 64, True, 48),
    (1, 1, 256, 256, 128, True, None),
    (2, 1, 128, 128, 128, False, None),
    (1, 1, 128, 256, 256, True, 100),
    (1, 1, 128, 128, 256, False, None),
]


@pytest.mark.parametrize("b,h,sq,sk,d,causal,window", FLASH_CASES)
def test_3xtf32_stays_within_the_float32_bound(b, h, sq, sk, d, causal,
                                               window):
    arrs = _qkv(sq + sk + d, b, h, sq, sk, d)
    got = flash_3xtf32_emulation(*map(torch.from_numpy, arrs),
                                 causal=causal, window=window).numpy()
    jx = [jnp.asarray(a) for a in arrs]
    oracle = np.asarray(R_ref.flash_attention_ref(*jx, causal=causal,
                                                  window=window))
    pallas = np.asarray(R_flash(*jx, causal=causal, window=window, bq=64,
                                bk=64, interpret=True))
    worst = []
    for want in (oracle, pallas):
        worst.append(float(np.max(np.abs(got - want))))
        np.testing.assert_allclose(got, want, rtol=F32_TOL, atol=F32_TOL)
    print((b, h, sq, sk, d, causal, window), worst)


@pytest.mark.parametrize("sq,sk,d,causal,window", [
    (77, 77, 128, True, None), (40, 200, 64, True, None),
    (33, 97, 256, False, 30), (100, 100, 32, False, None)])
def test_3xtf32_on_ragged_lengths(sq, sk, d, causal, window):
    """Lengths no tile divides: the masked tails stay out of the result."""
    arrs = _qkv(sq * 3 + sk, 1, 2, sq, sk, d)
    got = flash_3xtf32_emulation(*map(torch.from_numpy, arrs),
                                 causal=causal, window=window).numpy()
    want = np.asarray(R_ref.flash_attention_ref(
        *[jnp.asarray(a) for a in arrs], causal=causal, window=window))
    np.testing.assert_allclose(got, want, rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.parametrize("d", [64, 128, 256])
def test_one_tf32_product_breaks_the_float32_bound(d):
    """The same tile order with one TF32 product per product: the rounding
    of the operands to 11 bits moves the output far past 1e-5, so the
    three split products are what keep the bound."""
    arrs = _qkv(d, 1, 2, 128, 128, d)
    tt = [torch.from_numpy(a) for a in arrs]
    want = np.asarray(R_ref.flash_attention_ref(
        *[jnp.asarray(a) for a in arrs], causal=True))
    one = flash_3xtf32_emulation(*tt, mode="tf32").numpy()
    three = flash_3xtf32_emulation(*tt).numpy()
    err_one = float(np.max(np.abs(one - want)))
    err_three = float(np.max(np.abs(three - want)))
    print(d, "one TF32 product", err_one, "3xTF32", err_three)
    assert err_one > 10 * F32_TOL
    assert err_three <= F32_TOL


def test_tf32_rounding_is_to_nearest_ties_away():
    """Bit arithmetic as cvt.rna.tf32.f32: the 13 low bits cleared,
    exactly halfway rounds away from zero, and the rest of a split is
    exact (hi + lo recovers x to 2^-22 relative)."""
    ulp = 2.0 ** -10                         # TF32 ulp at 1.0
    x = torch.tensor([1.0, 1.0 + ulp / 2, 1.0 + ulp / 2 - 2 ** -23,
                      -(1.0 + ulp / 2), 3.0e-3, -7.5], dtype=torch.float32)
    r = tf32_rna(x)
    assert not (r.view(torch.int32) & 0x1FFF).any()
    assert r.tolist()[:4] == [1.0, 1.0 + ulp, 1.0, -(1.0 + ulp)]
    rng = np.random.default_rng(0)
    y = torch.from_numpy(rng.standard_normal(10000).astype(np.float32))
    hi, lo = split_tf32(y)
    assert torch.equal(y - hi - (y - hi), torch.zeros_like(y))
    rel = ((hi.double() + lo.double() - y.double()).abs()
           / y.double().abs()).max()
    assert float(rel) <= 2.0 ** -22


def test_the_emulation_without_the_tensor_cores_is_the_plain_softmax():
    """With the products taken in float32 the same tile order gives the
    plain version's attention: the TF32 split is the only change."""
    arrs = _qkv(3, 1, 2, 256, 256, 64)
    tt = [torch.from_numpy(a) for a in arrs]
    want = T_flash.flash_attention_ref(*tt, causal=True, window=40)
    got = flash_3xtf32_emulation(*tt, causal=True, window=40,
                                 mode="float32")
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6,
                               atol=1e-6)


# ------------------------------------------------ decode split across S

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


def decode_split_emulation(q_q, factor, k_q, v_q, k_scale, v_scale, pos, *,
                           bs):
    """The split kernel's order in plain torch, per (batch row, kv head):
    the splits of :func:`D.plan` that hold live keys (split 0 always),
    each with its logits' row max, float64 ``l`` partial and max ``pf``;
    the global max and (one block) the global ``p_s`` as maxima over the
    splits; int32 PV partials per split added (one block) or float32
    ``float(oi) * p_s`` terms per block summed in block order; ``l`` the
    split partials summed in split order, rounded to float32."""
    b, kvh, rep, hd = q_q.shape
    S = k_q.shape[1]
    p = D.plan(b, kvh, rep, hd, S, bs)
    keys, nb = p.split_keys, S // bs
    out = torch.empty((b, kvh, rep, hd), dtype=torch.float32)
    for bi in range(b):
        n_live = min(int(pos[bi]), S - 1) + 1
        live = max(1, -(-n_live // keys))
        spans = [(sp * keys, min(sp * keys + keys, n_live))
                 for sp in range(live)]
        li = torch.einsum("grd,sgd->grs", q_q[bi].to(torch.float64),
                          k_q[bi, :n_live].to(torch.float64)).to(torch.int32)
        logits = li.to(torch.float32) * factor[bi][..., None] \
            * k_scale[bi, :n_live].T[:, None, :]
        m = torch.full((kvh, rep), -1e30)
        for k0, k1 in spans:
            if k1 > k0:
                m = torch.maximum(m, logits[..., k0:k1].amax(-1))
        pe = torch.exp(logits - m[..., None])
        pf = pe * v_scale[bi, :n_live].T[:, None, :]
        lparts = [pe[..., k0:k1].to(torch.float64).sum(-1)
                  for k0, k1 in spans]
        pmax = [pf[..., k0:k1].amax(-1) if k1 > k0
                else torch.zeros((kvh, rep)) for k0, k1 in spans]
        vb = v_q[bi, :n_live].transpose(0, 1).to(torch.float64)   # (g,s,hd)

        def pv(codes, s0, s1):                  # exact int32 code . v
            return torch.einsum("grs,gsd->grd", codes.to(torch.float64),
                                vb[:, s0:s1]).to(torch.int32)
        acc = torch.zeros((kvh, rep, hd))
        if nb == 1:
            p_s = torch.stack(pmax).amax(0) / 127.0
            codes = torch.round(pf / p_s.clamp_min(1e-12)[..., None])
            oi = torch.zeros((kvh, rep, hd), dtype=torch.int32)
            for k0, k1 in spans:
                oi += pv(codes[..., k0:k1], k0, k1)
            acc = acc + oi.to(torch.float32) * p_s[..., None]
        else:
            for s0 in range(0, n_live, bs):     # block order
                s1 = min(s0 + bs, n_live)
                p_s = pf[..., s0:s1].amax(-1) / 127.0
                codes = torch.round(pf[..., s0:s1]
                                    / p_s.clamp_min(1e-12)[..., None])
                acc = acc + pv(codes, s0, s1).to(torch.float32) \
                    * p_s[..., None]
        l_sum = lparts[0]
        for part in lparts[1:]:                 # split order
            l_sum = l_sum + part
        out[bi] = acc / l_sum.to(torch.float32).clamp_min(1e-30)[..., None]
    return out


DECODE_CASES = [  # (b, kvh, rep, hd, S, bs)
    (2, 2, 3, 32, 512, 512),
    (2, 2, 3, 32, 512, 64),
    (1, 2, 4, 64, 512, 128),
    (3, 1, 1, 16, 256, 256),
    (1, 1, 8, 20, 1024, 1024),
]


@pytest.mark.parametrize("b,kvh,rep,hd,S,bs", DECODE_CASES)
def test_decode_split_order_equals_plain_bit_for_bit(b, kvh, rep, hd, S, bs):
    """Positions inside the first split, one before, on and one past a
    split boundary, and at S - 1: the emulation of the splits equals the
    plain version bit for bit, and the JAX oracle within 1e-5."""
    arrays = _decode_inputs(S + bs + rep, b, kvh, rep, hd, S)
    tt = [torch.from_numpy(a) for a in arrays]
    jx = [jnp.asarray(a) for a in arrays]
    q_q, factor = D.quantize_q(tt[0])
    keys = D.plan(b, kvh, rep, hd, S, bs).split_keys
    assert D.plan(b, kvh, rep, hd, S, bs).splits > 1
    worst = 0.0
    positions = [0, 5, keys - 1, keys, keys + 1, 2 * keys - 1, S // 2 + 3,
                 S - 1]
    for j in range(len(positions)):
        pos = torch.tensor([positions[(j + i) % len(positions)]
                            for i in range(b)], dtype=torch.int32)
        got = decode_split_emulation(q_q, factor, *tt[1:], pos, bs=bs)
        want = D.w8a8_decode_attention_body_ref(q_q, factor, *tt[1:], pos,
                                                bs=bs)
        assert torch.equal(got, want), (pos.tolist(), bs)
        for i in range(b):
            oracle = np.asarray(R_ref.w8a8_decode_attention_ref(
                *jx, jnp.int32(int(pos[i])), bs=bs))[i]
            worst = max(worst, float(np.max(np.abs(got[i].numpy()
                                                   - oracle))))
            np.testing.assert_allclose(got[i].numpy(), oracle,
                                       rtol=F32_TOL, atol=F32_TOL)
    print((b, kvh, rep, hd, S, bs), "vs oracle", worst)


# ------------------------------------------------------ the split planner

PHI4_DECODE = (4, 8, 3, 128)          # b, kvh, rep, hd at serving


def _check_plan(b, kvh, rep, hd, S, bs):
    p = D.plan(b, kvh, rep, hd, S, bs)
    keys = p.split_keys
    assert keys % 4 == 0 and keys >= 4
    # the splits cover [0, S), none empty
    assert (p.splits - 1) * keys < S <= p.splits * keys
    if bs < S:                       # a bs block never straddles splits
        assert keys % bs == 0
    assert p.blocks == b * kvh * p.splits
    nb = S // bs
    assert p.scratch == b * kvh * (4 * p.splits * rep + rep * S
                                   + (nb * rep * hd if nb > 1 else 0))
    assert p.workspace == b * kvh * rep * hd + b * kvh
    return p


@pytest.mark.parametrize("S", [4096, 32768])
@pytest.mark.parametrize("block", ["S", 512])
def test_plan_fills_the_card_at_the_phi4_shapes(S, block):
    bs = S if block == "S" else block
    p = _check_plan(*PHI4_DECODE, S, bs)
    assert p.blocks >= H100_SMS
    assert p.split_keys <= D.SPLIT_MAX_KEYS


@pytest.mark.parametrize("seed", range(6))
def test_plan_on_random_shapes(seed):
    rng = np.random.default_rng(seed)
    for _ in range(60):
        b, kvh = int(rng.integers(1, 9)), int(rng.integers(1, 17))
        rep = int(rng.choice([1, 2, 3, 4, 8, 16]))
        hd = 4 * int(rng.integers(1, 65))
        bs = int(rng.choice([1, 3, 16, 64, 100, 512, 2048]))
        S = bs * int(rng.integers(1, 40))
        p = _check_plan(b, kvh, rep, hd, S, bs)
        assert p.split_keys <= max(D.SPLIT_MAX_KEYS, 2 * bs)
        # the card filled unless the splits are at their shortest
        align = 4 if bs >= S else math.lcm(bs, 4)
        shortest = math.ceil(D.SPLIT_MIN_KEYS / align) * align
        assert p.blocks >= H100_SMS or p.split_keys == shortest


def test_the_decode_wrapper_refuses_cpu_tensors_with_its_counter_unmoved():
    arrays = _decode_inputs(0, 1, 1, 2, 16, 32)
    tt = [torch.from_numpy(a) for a in arrays]
    q_q, factor = D.quantize_q(tt[0])
    before = (D.launches, D.kernel_launches, D.last_grid)
    with pytest.raises(ValueError, match="CUDA tensors"):
        D.w8a8_decode_attention_body(q_q, factor, *tt[1:],
                                     torch.zeros(1, dtype=torch.int32),
                                     bs=32)
    assert (D.launches, D.kernel_launches, D.last_grid) == before


def test_decode_and_w8a8_split_k_share_one_workspace_module():
    """Both split kernels take the stream's zeroed buffer from the one
    neutral module, not from one another."""
    from repro_torch.kernels import _workspace as WS
    from repro_torch.kernels import w8a8_matmul as W8
    assert D.workspace is WS.workspace and W8.workspace is WS.workspace
