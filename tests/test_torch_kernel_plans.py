"""The host-side plans of the port's redesigned kernels, on the CPU.

* The W8A8 planner (``kernels/w8a8_matmul.plan``): the split-k ``dp4a``
  regime at decode, with at least 264 blocks (two per SM of an H100) on
  every phi4-mini projection shape; the tensor-core regime from
  ``TC_MIN_M`` on; splits that cover k with none empty; the workspace
  sizes it states; the persistent zeroed workspace.
* The W4A8 planner (``kernels/w4a8_matmul.plan``): below its
  ``TC_MIN_M`` the same split rule as W8A8 (``w8a8_matmul.split_k``),
  splits in whole quads of 4 k (so a packed pair of codes is never cut),
  the decode shapes' grids pinned; from ``TC_MIN_M`` on the tensor cores,
  one 128 x 128 tile a block; split-k forced above 16 rows on 16-row
  tiles.
* The W4A8 split-k kernel's arithmetic (``csrc/w4a8_matmul.cu``): a
  plain-torch emulation of its decode (PTX ``prmt`` with its sign
  replication, the magnitude bytes and the sign mask) over every pair of
  code bytes equals the port's ``pow2_integers`` and the JAX
  ``_decode_pow2_block`` x 2^7, +128 and -128 included; its split-k sum
  (``x.pos + (~x).neg + sum(neg)`` per split) equals the plain version bit
  for bit, and the JAX reference and Pallas kernel within their bound.
* The W4A8 tc kernel's arithmetic (``csrc/w4a8_matmul.cu``,
  ``w4a8_tc_kernel``): a plain-torch emulation of its ``decode_tile``
  (which thread writes which swizzled chunk of the K-major ``pos`` and
  ``neg`` tiles) over tiles holding every code byte equals
  ``pow2_integers`` and the JAX ``_decode_pow2_block`` x 2^7; the
  register fragment of ``~x`` that each thread loads from the swizzled x
  tile is ``~x`` in the wgmma A layout; the k32-step sum ``x.pos +
  (~x).neg`` over 128-k tiles plus each column's ``sum(neg)`` equals the
  plain version bit for bit over ragged k, and the JAX reference and
  Pallas kernel within their bound.
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
from repro.kernels.w4a8_matmul import _decode_pow2_block as R_decode_pow2
from repro.kernels.w4a8_matmul import w4a8_matmul as R_w4a8
from repro.quant import quantizers as R_qz
from repro_torch.kernels import flash_attention as T_flash
from repro_torch.kernels import w4a8_matmul as W4
from repro_torch.kernels import w8a8_matmul as W8

# phi4-mini-3.8b's projections: (k, n) of q/o, k/v, gate/up, down
PHI4_PROJ = ((3072, 3072), (3072, 1024), (3072, 8192), (8192, 3072))
# llama-3.2-vision-90b's: q/o, k/v (and context_kv), gate/up, down
LLAMA_PROJ = ((8192, 8192), (8192, 1024), (8192, 28672), (28672, 8192))
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


@pytest.mark.parametrize("m", [1, 4, W8.TC_MIN_M, 4096])
def test_plan_forces_either_regime_whatever_m(m):
    """``regime`` forces W8A8's regime, on the grid that regime plans
    from its own threshold; an unknown one is refused."""
    for k, n in PHI4_PROJ:
        assert W8.plan(m, k, n, "tc") == ("tc", 1, W8.TC_TILE, 0)
        assert W8.plan(m, k, n, "dp4a") == ("dp4a", *W8.split_k(m, k, n))
    with pytest.raises(ValueError, match="regime"):
        W8.plan(m, 64, 64, "splitk")


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


# ------------------------------------------------------------ W4A8 plans

def _w4_grid(p, m, n):
    tiles = math.ceil(m / p.row_tile) * math.ceil(n / W8.DP4A_COLS)
    return tiles, tiles * p.splits


@pytest.mark.parametrize("k,n", PHI4_PROJ)
@pytest.mark.parametrize("m", range(1, W8.TC_MIN_M))
def test_w4a8_plan_splits_k_on_the_phi4_decode_shapes(m, k, n):
    p = W4.plan(m, k, n)
    assert p.regime == "splitk"
    assert p.splits > 1
    assert _w4_grid(p, m, n)[1] >= 2 * H100_SMS


@pytest.mark.parametrize("k,n,splits,blocks", [
    (3072, 3072, 12, 288), (3072, 1024, 34, 272), (3072, 8192, 6, 384),
    (8192, 3072, 12, 288)])
def test_w4a8_decode_grids_are_unchanged(k, n, splits, blocks):
    """The m = 4 plans of the phi4 shapes: the split-k grids that the
    decode step has launched since the split-k kernel came (PERF.md's
    splits and blocks), W8A8's split rule, whatever regime the wrapper
    is forced to elsewhere."""
    p = W4.plan(4, k, n)
    assert p == W4.plan(4, k, n, "splitk") == ("splitk", *W8.split_k(4, k, n))
    assert (p.splits, p.row_tile) == (splits, 4)
    assert _w4_grid(p, 4, n)[1] == blocks
    assert p.workspace == 4 * n + math.ceil(n / 128)


@pytest.mark.parametrize("seed", range(4))
def test_w4a8_plan_splits_cover_k_in_whole_quads(seed):
    """Every split but the last walks ceil(quads / splits) quads of 4 k,
    the last the rest, none empty; so a split starts at a multiple of 4 k
    (an even packed row) even where k = 2 mod 4, and never cuts a packed
    pair.  The workspace holds m x n sums and one counter a tile; the
    grid is W8A8's."""
    rng = np.random.default_rng(40 + seed)
    for i in range(60):
        m = int(rng.integers(1, min(W4.TC_MIN_M, W8.TC_MIN_M)))
        k = 4 * int(rng.integers(1, 5000)) + (2 if i % 2 else 0)
        n = int(rng.integers(1, 9000))
        p = W4.plan(m, k, n)
        assert p.regime == "splitk"
        assert p[1:] == W8.split_k(m, k, n) == W8.plan(m, k, n)[1:]
        nq = math.ceil(k / 4)
        per = math.ceil(nq / p.splits)
        assert (p.splits - 1) * per < nq <= p.splits * per
        starts = [4 * per * z for z in range(p.splits)]
        assert all(s0 % 4 == 0 and s0 < k for s0 in starts)
        tiles, _ = _w4_grid(p, m, n)
        assert p.workspace == (m * n + tiles if p.splits > 1 else 0)


@pytest.mark.parametrize("m", [W8.TC_MIN_M, 64, 700, 4096])
def test_w4a8_plan_above_16_rows_is_split_k_on_16_row_tiles(m):
    """Split-k forced on prefill and ragged m takes the same split-k grid,
    16 rows a block: at least two blocks an SM on every phi4 shape, and
    no split where the tiles alone fill the card (m = 4096)."""
    for k, n in PHI4_PROJ:
        p = W4.plan(m, k, n, "splitk")
        assert p == ("splitk", *W8.split_k(m, k, n)) and p.row_tile == 16
        assert _w4_grid(p, m, n)[1] >= 2 * H100_SMS
        assert p.splits > 1 or _w4_grid(p, m, n)[0] >= 2 * H100_SMS
    assert m < 4096 or W4.plan(m, 3072, 3072, "splitk").splits == 1


@pytest.mark.parametrize("m", [W4.TC_MIN_M, W4.TC_MIN_M + 1, 64, 128, 700,
                               4 * 1601, 4096])
def test_w4a8_plan_takes_the_tensor_cores_from_its_threshold(m):
    """From W4A8's own TC_MIN_M on (prefill, the context fill's 4 x 1601
    rows), every phi4 and llama-3.2-vision shape runs on the tensor
    cores: one block a 128 x 128 tile, k unsplit, no workspace; below it
    (W8A8's tensor-core m included) split-k on W8A8's split grid."""
    for k, n in PHI4_PROJ + LLAMA_PROJ:
        p = W4.plan(m, k, n)
        assert p == ("tc", 1, 128, 0)
        assert p.row_tile == W8.TC_TILE
        for below in (W8.TC_MIN_M, W4.TC_MIN_M // 2, W4.TC_MIN_M - 1):
            assert W4.plan(below, k, n) == ("splitk",
                                            *W8.split_k(below, k, n))


def test_w4a8_plan_refuses_an_unknown_regime():
    assert W4.plan(4, 64, 64, "tc").regime == "tc"
    with pytest.raises(ValueError, match="regime"):
        W4.plan(4, 64, 64, "dp4a")


def test_the_w4a8_wrapper_refuses_cpu_tensors_with_its_counters_unmoved():
    x = torch.zeros((4, 64), dtype=torch.int8)
    w = torch.zeros((32, 32), dtype=torch.int8)
    before = (W4.launches, W4.launches_splitk, W4.launches_tc, W4.last_grid)
    for regime in (None, "splitk", "tc"):
        with pytest.raises(ValueError, match="CUDA tensors"):
            W4.w4a8_matmul(x, w, torch.ones(()), torch.ones(32),
                           regime=regime)
    assert (W4.launches, W4.launches_splitk, W4.launches_tc,
            W4.last_grid) == before


# ------------------------------- W4A8 split-k: the kernel's arithmetic

K_MAG_LO, K_MAG_HI = 0x08040201, 0x80402010    # bytes 2^0 .. 2^7
U32 = 0xFFFFFFFF


def prmt(a, b, s):
    """PTX ``prmt.b32`` in its generic mode on int64 tensors holding
    32-bit words: byte i of the result is byte ``s[4i+2:4i]`` of {b, a},
    or that byte's bit 7 replicated over the byte when ``s[4i+3]`` is
    set."""
    a, b, s = (torch.as_tensor(t, dtype=torch.int64) for t in (a, b, s))
    out = torch.zeros(torch.broadcast_shapes(a.shape, b.shape, s.shape),
                      dtype=torch.int64)
    for i in range(4):
        nib = (s >> (4 * i)) & 15
        idx = nib & 7
        byte = (torch.where(idx < 4, a, b) >> (8 * (idx & 3))) & 0xFF
        byte = torch.where((nib & 8) != 0,
                           torch.where(byte >= 0x80, 0xFF, 0), byte)
        out = out | (byte << (8 * i))
    return out


def decode_pow2(w0, w1, c: int):
    """The kernel's ``decode_pow2``: column c's four codes (byte c of the
    words of packed rows 2q and 2q + 1) -> (pos, neg) words of magnitude
    bytes in k order."""
    sel = prmt(w0, w1, 0x40 + 0x11 * c)
    mag = prmt(K_MAG_LO, K_MAG_HI, sel & 0x7777)
    sgn = prmt(0x80808080, 0x80808080, sel)
    rot = ((sgn << 1) | (sgn >> 31)) & U32
    return mag & ~(sgn & rot) & U32, mag & sgn & rot


def _bytes(word):
    """(..., ) words -> (..., 4) bytes, byte j at index j."""
    return torch.stack([(word >> (8 * j)) & 0xFF for j in range(4)], -1)


def test_register_decode_equals_the_reference_decode_on_every_code_pair():
    """All 65,536 pairs of code bytes in each of the four column slots of
    a word (the other bytes random): pos - neg, byte by byte, is
    ``pow2_integers`` and the JAX ``_decode_pow2_block`` x 2^7; pos and
    neg are disjoint magnitudes 2^e; +128 (code 0x7) and -128 (0xf)
    among them."""
    b0, b1 = (t.reshape(-1) for t in torch.meshgrid(
        torch.arange(256), torch.arange(256), indexing="ij"))
    packed = torch.stack([b0, b1]).to(torch.uint8).view(torch.int8)
    want = W4.pow2_integers(packed).to(torch.int64).T       # (65536, 4)
    jax_want = np.asarray(R_decode_pow2(jnp.asarray(packed.numpy()))).T
    np.testing.assert_array_equal(jax_want * 2 ** 7, want.numpy())
    assert {int(want.max()), int(want.min())} == {128, -128}
    rng = np.random.default_rng(3)
    for c in range(4):
        w0, w1 = (torch.from_numpy(rng.integers(0, 2 ** 32, 65536,
                                                dtype=np.int64))
                  for _ in range(2))
        w0 = (w0 & ~(0xFF << (8 * c))) | (b0 << (8 * c))
        w1 = (w1 & ~(0xFF << (8 * c))) | (b1 << (8 * c))
        pos, neg = decode_pow2(w0, w1, c)
        pb, nb = _bytes(pos), _bytes(neg)
        assert torch.equal(pb - nb, want), c
        assert not (pb * nb).any()
        mags = pb + nb
        assert torch.equal(mags & (mags - 1), torch.zeros_like(mags))


def splitk_emulation(x_q, w_packed, x_scale, w_scale, splits: int):
    """The split-k kernel's arithmetic in plain torch: the codes decoded
    as ``decode_pow2`` does, k padded to whole quads with x = 0 (the
    masked loads), each split's partial ``x.pos + (~x).neg + sum(neg)``
    over its ``ceil(quads / splits)`` quads, the partials summed in int32,
    then ``((float(acc) * 2^-7) * x_scale) * w_scale``."""
    m, k = x_q.shape
    kp, n = w_packed.shape
    nq = -(-k // 4)
    per = -(-nq // splits)
    assert -(-nq // per) == splits
    n4 = -(-n // 4) * 4
    wb = torch.nn.functional.pad(w_packed.to(torch.int64) & 0xFF,
                                 (0, n4 - n, 0, 2 * nq - kp))
    words = (wb.reshape(2 * nq, n4 // 4, 4)
             << torch.tensor([0, 8, 16, 24])).sum(-1)
    pos = torch.empty((nq, n4 // 4, 4, 4), dtype=torch.int64)
    neg = torch.empty_like(pos)
    for c in range(4):
        p, q = decode_pow2(words[0::2], words[1::2], c)
        pos[:, :, c], neg[:, :, c] = _bytes(p), _bytes(q)
    # (quads, column, k in quad) -> (quads, k in quad, column)
    pos = pos.reshape(nq, n4, 4).transpose(1, 2)
    neg = neg.reshape(nq, n4, 4).transpose(1, 2)
    xb = torch.nn.functional.pad(x_q.to(torch.int64),
                                 (0, 4 * nq - k)).reshape(m, nq, 4)
    acc = torch.zeros((m, n4), dtype=torch.int64)
    for z in range(splits):
        qs = slice(z * per, min(nq, (z + 1) * per))
        part = (torch.einsum("mqj,qjn->mn", xb[:, qs], pos[qs])
                + torch.einsum("mqj,qjn->mn", ~xb[:, qs], neg[qs])
                + neg[qs].sum((0, 1)))
        acc = acc + part
    acc = acc[:, :n].to(torch.int32)
    out = acc.to(torch.float32) * 2.0 ** -7
    return out * x_scale * w_scale


def _w4_operands(m, k, n, seed):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.integers(-128, 128, (m, k), dtype=np.int8))
    w = torch.from_numpy(rng.integers(-128, 128, (k // 2, n),
                                      dtype=np.int8))
    xs = torch.tensor(rng.uniform(1e-3, 1e-1), dtype=torch.float32)
    ws = torch.from_numpy(rng.uniform(1e-3, 1e-1, n).astype(np.float32))
    return x, w, xs, ws


@pytest.mark.parametrize("m,k,n", [(4, 3072, 1024), (3, 130, 257),
                                   (16, 66, 200), (1, 8190, 130),
                                   (7, 1002, 999)])
def test_splitk_emulation_equals_the_plain_version_bit_for_bit(m, k, n):
    """At the plan's split count and at forced ones (one split, two, one
    quad a split), k = 2 mod 4 and ragged n among the shapes."""
    ops = _w4_operands(m, k, n, m * k + n)
    want = W4.w4a8_matmul_ref(*ops)
    nq = -(-k // 4)
    counts = {W4.plan(m, k, n).splits, 1, 2, nq}
    for splits in sorted(c for c in counts
                         if -(-nq // -(-nq // c)) == c):
        got = splitk_emulation(*ops, splits)
        assert torch.equal(got, want), splits


@pytest.mark.parametrize("m,k,n", [(16, 64, 96), (32, 128, 48),
                                   (8, 256, 32)])
def test_splitk_emulation_close_to_the_jax_reference_and_pallas(m, k, n):
    """Operands quantized by the reference (pow2 codes of normal weights,
    per-column scales) and handed to both packages: the emulated kernel
    at its planned split count is within the reference's W4A8 bound
    (``tests/test_torch_quant.py``) of ``ref.w4a8_matmul_ref`` and of the
    Pallas kernel in interpret mode."""
    rng = np.random.default_rng(m + k + n)
    x = jnp.asarray(rng.standard_normal((m, k)).astype(np.float32))
    w = jnp.asarray(rng.standard_normal((k, n)).astype(np.float32))
    xs = R_qz.int_scale(x, 8)
    xq = R_qz.quantize_int(x, xs, 8)
    ws = R_qz.pow2_scale(w, axis=0)
    wq = R_qz.pack_int4(R_qz.pow2_encode(w, ws).T).T
    t = [torch.from_numpy(np.array(a)) for a in (xq, wq, xs, ws)]
    t[2], t[3] = t[2].reshape(()), t[3].reshape(-1)
    splits = W4.plan(m, k, n).splits
    got = splitk_emulation(*t, splits).numpy()
    for want in (R_ref.w4a8_matmul_ref(xq, wq, xs, ws),
                 R_w4a8(xq, wq, xs, ws, bm=8, bn=16, bk=32,
                        interpret=True)):
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5,
                                   atol=1e-5)
    assert np.array_equal(got, W4.w4a8_matmul_ref(*t).numpy())


# ---------------------------------- W4A8 tc: the kernel's arithmetic

TK, TKP, TN = 128, 64, 128      # the tc tile: k, packed rows, columns


def swizzle128(off):
    """``tc::swizzle128``: chunk bits 4-6 of a byte offset XOR its row's
    low three bits (bits 7-9)."""
    return off ^ (((off >> 7) & 7) << 4)


def decode_tile_emulation(raw):
    """The kernel's ``decode_tile``: a packed tile ``(64, 128)`` of bytes
    -> the pos and neg tiles as shared memory holds them, 16384 bytes
    each, and how many times each byte was written.  Thread (warp, lane)
    reads packed rows 8 warp .. + 7 of columns 4 lane .. + 3 a word a row;
    store s decodes column 4 lane + (s + lane / 2) % 4 and writes its 16
    k bytes (quads 4 warp .. + 3) at the swizzled chunk of column row
    ``col``, chunk ``warp``."""
    b = torch.as_tensor(raw, dtype=torch.int64) & 0xFF
    words = (b.reshape(TKP, 32, 4) << torch.tensor([0, 8, 16, 24])).sum(-1)
    # axes: store s, quad g, warp, lane, byte j
    st = torch.arange(4)[:, None, None, None]
    g = torch.arange(4)[None, :, None, None]
    warp = torch.arange(8)[None, None, :, None]
    lane = torch.arange(32)[None, None, None, :]
    c = (st + ((lane >> 1) & 3)) & 3
    w0 = words[8 * warp + 2 * g, lane]
    w1 = words[8 * warp + 2 * g + 1, lane]
    at = (swizzle128((4 * lane + c) * TK + 16 * warp) + 4 * g)[..., None] \
        + torch.arange(4)
    tiles = []
    for word in decode_pow2(w0, w1, c):
        tile = torch.zeros(TN * TK, dtype=torch.int64)
        tile[at.reshape(-1)] = ((word[..., None] >> (8 * torch.arange(4)))
                                & 0xFF).reshape(-1)
        tiles.append(tile)
    writes = torch.bincount(at.reshape(-1), minlength=TN * TK) * 2
    return tiles[0], tiles[1], writes


def k_major(tile):
    """A swizzled 128 x 128 shared-memory tile -> (rows, k bytes)."""
    off = torch.arange(TN)[:, None] * TK + torch.arange(TK)[None, :]
    return tile[swizzle128(off)]


def not_x_fragments(x_smem):
    """``~x`` as each thread of the tc block loads it: the swizzled x tile
    (128 rows of 128 k bytes) read at the kernel's offsets, word nx[kk][i]
    of thread t, reassembled at the place the wgmma A fragment gives it
    (warp w of warpgroup wg: rows 64 wg + 16 w + l / 4 (+ 8 for odd i),
    bytes 32 kk + 4 (l % 4) (+ 16 for i >= 2))."""
    got = torch.full((128, TK), -1, dtype=torch.int64)
    for t in range(256):
        wg, warp, lane = t // 128, (t % 128) // 32, t % 32
        frag = (wg * 64 + warp * 16 + lane // 4) * TK + 4 * (lane % 4)
        for kk in range(4):
            for i in range(4):
                at = swizzle128(frag + 8 * TK * (i & 1) + 32 * kk
                                + 16 * (i >> 1))
                word = ~x_smem[at:at + 4] & 0xFF
                row = 64 * wg + 16 * warp + lane // 4 + 8 * (i & 1)
                k0 = 32 * kk + 4 * (lane % 4) + 16 * (i >> 1)
                got[row, k0:k0 + 4] = word
    return got


def tc_emulation(x_q, w_packed, x_scale, w_scale):
    """The tc kernel in plain torch: x and the codes cut into 128 x 128
    output tiles and 128-k tiles, zero past m, k and n (the masked
    copies); each packed tile decoded as ``decode_tile`` does, each k32
    step adding ``x.pos + (~x).neg`` into one int32 accumulator, each
    column's ``sum(neg)`` gathered over the tiles and added once; then
    ``((float(acc) * 2^-7) * x_scale) * w_scale``."""
    m, k = x_q.shape
    n = w_packed.shape[1]
    nk, nt = -(-k // TK), -(-n // TN)
    xp = torch.nn.functional.pad(x_q.to(torch.int64), (0, nk * TK - k))
    wp = torch.nn.functional.pad(w_packed.to(torch.int64),
                                 (0, nt * TN - n, 0, nk * TKP - k // 2))
    acc = torch.zeros((m, nt * TN), dtype=torch.int64)
    for ct in range(nt):
        cols = slice(ct * TN, (ct + 1) * TN)
        col_neg = torch.zeros(TN, dtype=torch.int64)
        for t in range(nk):
            pos, neg, _ = decode_tile_emulation(
                wp[t * TKP:(t + 1) * TKP, cols])
            pos, neg = k_major(pos), k_major(neg)
            col_neg += neg.sum(1)
            for kk in range(TK // 32):
                ks = slice(t * TK + 32 * kk, t * TK + 32 * kk + 32)
                xs = xp[:, ks]
                acc[:, cols] += (xs @ pos[:, 32 * kk:32 * kk + 32].T
                                 + ~xs @ neg[:, 32 * kk:32 * kk + 32].T)
        acc[:, cols] += col_neg
    acc = acc[:, :n]
    assert int(acc.abs().max()) < 2 ** 31
    out = acc.to(torch.int32).to(torch.float32) * 2.0 ** -7
    return out * x_scale * w_scale


def test_tc_decode_tile_equals_the_reference_decode_on_every_code():
    """Tiles whose bytes run through all 256 values in every column (so
    every pair of codes, +128 = 0x7 and -128 = 0xf among them): each byte
    of the pos and neg tiles written once, pos - neg at (column, k) is
    ``pow2_integers`` and the JAX ``_decode_pow2_block`` x 2^7 there, pos
    and neg disjoint powers of two."""
    rng = np.random.default_rng(11)
    for t in range(4):
        raw = torch.from_numpy(rng.permutation(
            np.tile(np.arange(256, dtype=np.uint8), TKP * TN // 256))
            .reshape(TKP, TN)).view(torch.int8)
        if t == 0:                 # each column walks the byte values
            raw = (torch.arange(TKP)[:, None] * 4 + torch.arange(TN)[None, :]
                   ).remainder(256).to(torch.uint8).view(torch.int8)
        pos, neg, writes = decode_tile_emulation(raw)
        assert torch.equal(writes, torch.full_like(writes, 2))
        want = W4.pow2_integers(raw).to(torch.int64).T        # (n, k)
        jax_want = np.asarray(R_decode_pow2(jnp.asarray(raw.numpy()))).T
        np.testing.assert_array_equal(jax_want * 2 ** 7, want.numpy())
        pk, nk_ = k_major(pos), k_major(neg)
        assert torch.equal(pk - nk_, want)
        assert not (pk * nk_).any()
        mags = pk + nk_
        assert torch.equal(mags & (mags - 1), torch.zeros_like(mags))
    assert {int(want.max()), int(want.min())} == {128, -128}


def test_tc_not_x_fragments_are_the_wgmma_a_layout():
    """The words each thread loads from the swizzled x tile and inverts
    are ~x at the places the wgmma register A fragment gives them: every
    (row, k) of the 128 x 128 tile once, x = -128 and 127 among them."""
    rng = np.random.default_rng(12)
    x = torch.from_numpy(rng.integers(-128, 128, (128, TK))).to(torch.int64)
    x[0, 0], x[5, 77] = -128, 127
    smem = torch.zeros(128 * TK, dtype=torch.int64)
    off = torch.arange(128)[:, None] * TK + torch.arange(TK)[None, :]
    smem[swizzle128(off)] = x & 0xFF
    got = not_x_fragments(smem)
    assert torch.equal(got, ~x & 0xFF)


@pytest.mark.parametrize("m,k,n", [(3, 130, 257), (17, 66, 200),
                                   (130, 258, 131), (20, 512, 256),
                                   (1, 8190, 130)])
def test_tc_emulation_equals_the_plain_version_bit_for_bit(m, k, n):
    """Ragged m, k = 2 mod 4 (a packed tile's last rows and x's last k
    masked to zero) and n, one and several 128-k tiles and column tiles;
    the extremes (every code +128 or -128, x = -128 and 127) at k 512."""
    ops = _w4_operands(m, k, n, 7 * m + k + n)
    assert torch.equal(tc_emulation(*ops), W4.w4a8_matmul_ref(*ops))
    x, _, xs, ws = ops
    x = x.clone()
    x[0] = -128
    x[-1, ::2] = 127
    for byte in (0x77, -1):             # all +128, all -128
        w = torch.full((k // 2, n), byte, dtype=torch.int8)
        assert torch.equal(tc_emulation(x, w, xs, ws),
                           W4.w4a8_matmul_ref(x, w, xs, ws)), byte


@pytest.mark.parametrize("m,k,n", [(16, 64, 96), (32, 256, 48),
                                   (8, 258, 32)])
def test_tc_emulation_close_to_the_jax_reference_and_pallas(m, k, n):
    """Operands quantized by the reference, as for the split-k emulation:
    the emulated tc kernel within the reference's W4A8 bound of
    ``ref.w4a8_matmul_ref`` and of the Pallas kernel in interpret mode,
    and equal to the port's plain version."""
    rng = np.random.default_rng(m + k + n + 1)
    x = jnp.asarray(rng.standard_normal((m, k)).astype(np.float32))
    w = jnp.asarray(rng.standard_normal((k, n)).astype(np.float32))
    xs = R_qz.int_scale(x, 8)
    xq = R_qz.quantize_int(x, xs, 8)
    ws = R_qz.pow2_scale(w, axis=0)
    wq = R_qz.pack_int4(R_qz.pow2_encode(w, ws).T).T
    t = [torch.from_numpy(np.array(a)) for a in (xq, wq, xs, ws)]
    t[2], t[3] = t[2].reshape(()), t[3].reshape(-1)
    got = tc_emulation(*t).numpy()
    for want in (R_ref.w4a8_matmul_ref(xq, wq, xs, ws),
                 R_w4a8(xq, wq, xs, ws, bm=8, bn=16, bk=2 if k % 4 else 32,
                        interpret=True)):
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5,
                                   atol=1e-5)
    assert np.array_equal(got, W4.w4a8_matmul_ref(*t).numpy())


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
