"""Flash attention forward: tiled online-softmax attention.

Replaces the Pallas TPU kernel ``repro/kernels/flash_attention.py``
(``_flash_kernel``, built around its ``pl.pallas_call`` in
``flash_attention``) with CUDA kernels written for Hopper in two regimes;
each source's header says what bounds it and how it is laid out.

The **tile** regime, one kernel per operand dtype, for calls with many q
rows (a forward, a prefill):

* bfloat16: ``csrc/flash_attention_tc.cu``, both products on the bf16
  tensor cores (``wgmma``), for every d in :data:`HEAD_DIMS` (d below 64
  is zero-padded to 64 in shared memory).  The tensor cores take P in
  bf16, which the TPU kernel keeps in float32: the kernel splits P into
  two bf16 parts (~16 bits) for two PV products, within the bf16 bound
  of 2e-2.
* float32: ``csrc/flash_attention.cu``, both products on the TF32 tensor
  cores (``wgmma``) in three products on split operands (3xTF32): each
  operand is a TF32 hi part plus a TF32 lo part (the float32 rest), and
  ``a . b = a_lo . b_hi + a_hi . b_lo + a_hi . b_hi`` in float32, ~2^-21
  relative a product where one TF32 product alone (~1e-3) would break the
  float32 bound of 1e-5.  The softmax stays float32 on the CUDA cores.

The **decode** regime, ``csrc/flash_decode.cuh`` (built for bf16 by
``csrc/flash_decode.cu`` and for float32 by ``csrc/flash_decode_f32.cu``),
for calls with few q
rows (``sq <= DECODE_MAX_SQ``: the cross-attention of a vlm or audio
decode step): the keys split across blocks (:func:`decode_plan`), each
block taking all ``rep * sq`` q rows of its kv head, so k and v are read
once with ``kvh`` heads, through their strides, where the model keeps
them; logits, softmax and P.V in float32 on the CUDA cores, both dtypes.
The splits meet in a scratch buffer and the per-stream zeroed workspace
(``kernels/_workspace.py``).  ``regime=`` forces either; a ``"tile"``
call with ``kvh < h`` repeats the kv heads first.

Same function as the TPU kernel: q ``(b, h, sq, d)``, k, v ``(b, kvh, sk,
d)`` with ``h % kvh == 0`` (q head ``g * rep + j`` reads kv head ``g``, the
reference's broadcast), float32 or bfloat16, computed in float32; causal
mask, optional sliding window (``ki > qi - window``), or neither; the last
q row aligned to the last key (``qi = i + sk - sq``); masked logits
filled with -1e30 and ``l`` floored at 1e-30; out in q's dtype.  Unlike
the TPU entry point, any ``sq`` and ``sk`` are taken: the kernels mask
ragged tails themselves, so nothing is padded.

The plain version :func:`flash_attention_ref` follows
``ref.flash_attention_ref`` on the kv heads repeated to ``h``: a dense
float32 softmax over all keys with -1e30 in the masked places (the
oracle's ``-inf`` gives the same wherever a row has a live key; a row
with none, causal with ``sq > sk``, gets the mean of v where the oracle
gives NaN) and the scale ``d^-0.5`` as a float, the TPU kernel's (the
reference's oracle rounds the scale to q's dtype first).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.kernels._workspace import current_stream, workspace

#: head dims the kernels are built for
HEAD_DIMS = (16, 32, 64, 128, 256)
_INT_MAX = 2 ** 31 - 1
NEG_INF = -1e30

#: the regimes, and the most q rows (sq) a call sends to the decode
#: regime when none is forced: the largest sq at which the decode kernel
#: beat the tile kernel alone on llama-3.2-vision's and whisper's decode
#: cross-attention (kernel times at sq 1-64 on an H100, chip_smoke.py's
#: ``flash_decode`` phase and tools/time_flash_decode.py; PERF.md).  With
#: the tile route's repeat and transposes counted the decode regime won
#: up to sq 16, but a short forward's self-attention pays only small
#: transposes there
REGIMES = ("tile", "decode")
DECODE_MAX_SQ = 2
#: the decode regime's split: blocks it aims for (two per SM of an H100's
#: 132), keys a split reads at least, and the warps of a block
DECODE_TARGET_BLOCKS = 264
DECODE_MIN_KEYS = 64
DECODE_WARPS = 8

#: kernel launches since the counters were last set to 0: all of them,
#: the tile regime's bf16 route's and float32 (3xTF32) route's, the decode
#: regime's (either dtype), and those with a sliding window (any)
launches = 0
launches_tc = 0
launches_f32 = 0
launches_decode = 0
launches_windowed = 0
#: the decode regime's last grid as its C entry reported it: (b * kvh,
#: splits)
last_grid = None


def _scale(d: int, scale) -> float:
    return float(scale) if scale is not None else float(d) ** -0.5


def _mask(sq: int, sk: int, causal: bool, window, device) -> torch.Tensor:
    qi = torch.arange(sq, device=device)[:, None] + (sk - sq)
    ki = torch.arange(sk, device=device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=device)
    if causal:
        mask &= ki <= qi
    if window is not None:
        mask &= ki > qi - window
    return mask


@functools.lru_cache(maxsize=256)
def live_pairs(sq: int, sk: int, causal: bool, window: int | None) -> int:
    """(query, key) pairs the mask keeps: row ``i`` is position
    ``i + sk - sq``; causal keeps keys up to it, a window those after
    ``position - window``."""
    total = 0
    for i in range(sq):
        qi = i + sk - sq
        hi = min(qi, sk - 1) if causal else sk - 1
        lo = 0 if window is None else max(0, qi - window + 1)
        total += max(0, hi - lo + 1)
    return total


def cost(b: int, h: int, sq: int, sk: int, d: int, *, causal: bool,
         window: int | None, dtype, kvh: int | None = None
         ) -> tuple[float, float, str]:
    """``(FLOPs, bytes, class)`` of one call, from the function it
    computes: QK^T and PV, 4 d FLOPs a live (query, key) pair
    (:func:`live_pairs`) a head; q read once, k and v once at their
    ``kvh`` heads (``h`` where not given), the output written once.  Class
    ``bf16`` for bf16 operands, ``fp32_dot`` for float32 (the tile
    regime's 3xTF32 route)."""
    kvh = h if kvh is None else kvh
    return (4.0 * d * b * h * live_pairs(sq, sk, causal, window),
            float(2 * (sq * h + sk * kvh) * b * d * dtype.itemsize),
            "bf16" if dtype in (torch.bfloat16, torch.float16)
            else "fp32_dot")


def broadcast_kv(t: torch.Tensor, h: int) -> torch.Tensor:
    """(b, kvh, s, d) -> (b, h, s, d), each kv head repeated ``h / kvh``
    times (q head ``g * rep + j`` reads kv head ``g``)."""
    rep = h // t.shape[1]
    return t if rep == 1 else torch.repeat_interleave(t, rep, dim=1)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: int | None = None,
                        scale: float | None = None) -> torch.Tensor:
    """The plain version: q ``(b, h, sq, d)``, k, v ``(b, kvh, sk, d)``
    with the kv heads repeated to ``h`` first; out ``(b, h, sq, d)`` in
    q's dtype."""
    h, sq, d = q.shape[1], q.shape[2], q.shape[3]
    kvh, sk = k.shape[1], k.shape[2]
    if h % kvh:
        raise ValueError(f"flash_attention: k and v need kvh dividing h = "
                         f"{h}, got kvh = {kvh}")
    k, v = broadcast_kv(k, h), broadcast_kv(v, h)
    logits = torch.einsum("bhqd,bhkd->bhqk", q.to(torch.float32),
                          k.to(torch.float32)) * _scale(d, scale)
    logits = logits.masked_fill(
        ~_mask(sq, sk, causal, window, q.device), NEG_INF)
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", p, v.to(torch.float32))
    return out.to(q.dtype)


def check_operands(q, k, v, window) -> tuple[int, int, int, int, int, int]:
    """Validate the operands; returns ``(b, h, kvh, sq, sk, d)``."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(
            f"flash_attention: q, k, v must be (b, h, s, d), got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, h, sq, d = q.shape
    kvh, sk = k.shape[1], k.shape[2]
    if k.shape[0] != b or k.shape[3] != d or h % kvh \
            or tuple(v.shape) != tuple(k.shape):
        raise ValueError(
            f"flash_attention: k and v must be ({b}, kvh, sk, {d}) alike "
            f"with kvh dividing h = {h}, got {tuple(k.shape)} and "
            f"{tuple(v.shape)}")
    if min(b, h, sq, sk) < 1:
        raise ValueError("flash_attention: empty operands")
    if q.dtype not in (torch.float32, torch.bfloat16) \
            or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(
            f"flash_attention: q, k, v float32 or bfloat16 alike, got "
            f"{q.dtype}, {k.dtype}, {v.dtype}")
    if window is not None and window < 1:
        raise ValueError(f"flash_attention: window must be >= 1, got "
                         f"{window}")
    for t in (k, v):
        if t.device != q.device:
            raise ValueError(
                f"flash_attention: operands on {t.device} and {q.device}")
    return b, h, kvh, sq, sk, d


def regime_for(sq: int, regime: str | None = None) -> str:
    """The regime a call of ``sq`` q rows takes: ``regime`` where given,
    else ``"decode"`` up to :data:`DECODE_MAX_SQ` rows and ``"tile"``
    above."""
    if regime is None:
        return "decode" if sq <= DECODE_MAX_SQ else "tile"
    if regime not in REGIMES:
        raise ValueError(f"flash_attention: regime must be one of "
                         f"{REGIMES} or None, got {regime!r}")
    return regime


class DecodePlan(NamedTuple):
    """How a decode-regime call runs: ``rt`` q rows a lane group keeps
    (``passes`` of them cover the ``rep * sq`` rows), ``slices`` of a
    split (each group's keys: every ``slices``-th), the keys
    ``[key_lo, sk)`` in ``splits`` of ``split_keys``, ``blocks`` of the
    grid (``b * kvh * splits``), and the buffers' sizes the C entry
    checks: ``scratch`` float32 (each split's partial m, l and acc) and
    ``workspace`` int32 (one arrival counter per (b, kv head))."""
    rt: int
    passes: int
    slices: int
    key_lo: int
    split_keys: int
    splits: int
    blocks: int
    scratch: int
    workspace: int


def decode_key_lo(sq: int, sk: int, causal: bool, window) -> int:
    """The first key any row can see: the first row's window start, or 0
    where a row has no live key (causal, ``sq > sk``: it takes the mean
    of v over every key, as a dense softmax of -1e30 logits does)."""
    if window is None or (causal and sq > sk):
        return 0
    return max(0, sk - sq - window + 1)


@functools.lru_cache(maxsize=256)
def decode_plan(b: int, h: int, kvh: int, sq: int, sk: int, d: int, dtype,
                *, causal: bool, window) -> DecodePlan:
    """The decode regime's layout of one call, its one owner: the C entry
    of ``csrc/flash_decode.cuh`` takes ``rt``, ``slices``, ``key_lo`` and
    ``split_keys`` from it and only checks them against what the kernel
    is built for.  A lane group of ``min(8, words)`` lanes a key (a row's
    16-byte words shared among them), ``32 / lanes`` groups a warp;
    ``rt`` the least power of two with which a warp's groups cover every
    row of a key at once, up to 8 and to 64 q elements a lane (q and acc
    in 128 registers); the live keys split so that the
    grid has :data:`DECODE_TARGET_BLOCKS` blocks, none reading fewer than
    :data:`DECODE_MIN_KEYS` keys or less than 4x the bytes its partial
    writes."""
    es = dtype.itemsize
    words = d * es // 16
    lanes = min(8, words)
    ng = 32 // lanes
    groups = DECODE_WARPS * ng
    rows = (h // kvh) * sq
    rt_max = min(8, 64 * es // (16 * (words // lanes)))
    rt = 1
    while rt < rt_max and rt * ng < rows:
        rt *= 2
    passes = -(-rows // rt)
    slices = 1 if passes >= groups else groups // passes
    key_lo = decode_key_lo(sq, sk, causal, window)
    live = sk - key_lo
    bg = b * kvh
    min_keys = max(DECODE_MIN_KEYS, -(-8 * rows * (d + 2) // (d * es)))
    splits = max(1, min(DECODE_TARGET_BLOCKS // bg, -(-live // min_keys)))
    split_keys = -(-live // splits)
    splits = -(-live // split_keys)
    many = splits > 1
    return DecodePlan(rt, passes, slices, key_lo, split_keys, splits,
                      bg * splits, bg * splits * rows * (d + 2) if many else 0,
                      bg if many else 0)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int | None = None,
                    scale: float | None = None,
                    regime: str | None = None) -> torch.Tensor:
    """The CUDA kernels: q ``(b, h, sq, d)``, k, v ``(b, kvh, sk, d)`` on one
    CUDA device, ``d`` in :data:`HEAD_DIMS`, in the regime
    :func:`regime_for` picks.  The decode regime
    (``csrc/flash_decode.cuh``) reads every operand through its strides (d
    contiguous, 16-byte aligned rows) and returns ``(b, h, sq, d)`` laid
    out as ``(b, sq, h, d)``; the tile regime takes contiguous copies
    (the kv heads repeated first where ``kvh < h``; operands already
    contiguous are not copied): bfloat16 to the bf16
    tensor-core kernel (``csrc/flash_attention_tc.cu``), float32 to the
    3xTF32 kernel (``csrc/flash_attention.cu``).  Raises on a CPU tensor,
    a failed build or a failed launch."""
    global launches, launches_tc, launches_f32, launches_windowed
    b, h, kvh, sq, sk, d = check_operands(q, k, v, window)
    device = q.device
    if device.type != "cuda":
        raise ValueError(
            f"flash_attention: the kernel takes CUDA tensors, got {device}; "
            f"the plain version runs on the CPU (ops impl='auto' or 'ref')")
    if d not in HEAD_DIMS:
        raise ValueError(
            f"flash_attention: the kernel is built for head dims "
            f"{HEAD_DIMS}, got {d}")
    if regime_for(sq, regime) == "decode":
        return _decode(q, k, v, causal, window, scale)
    q, k, v = (t.contiguous() for t in
               (q, broadcast_kv(k, h), broadcast_kv(v, h)))
    tc = q.dtype == torch.bfloat16
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_attention: operands must start on 16-byte "
                         "boundaries")
    from repro_torch.kernels import _build
    window_arg = 0 if window is None else min(int(window), _INT_MAX)
    ptrs = [ctypes.c_void_p(t.data_ptr()) for t in (q, k, v)]
    with torch.cuda.device(device):
        out = torch.empty_like(q)
        stream = ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
        if tc:
            lib = _build.library("flash_attention_tc")
            err = lib.qappa_flash_attention_tc(
                *ptrs, ctypes.c_void_p(out.data_ptr()), b * h, sq, sk, d,
                int(causal), window_arg, ctypes.c_float(_scale(d, scale)),
                stream)
        else:
            lib = _build.library("flash_attention")
            err = lib.qappa_flash_attention(
                *ptrs, ctypes.c_void_p(out.data_ptr()), b * h, sq, sk, d,
                int(causal), window_arg, ctypes.c_float(_scale(d, scale)),
                stream)
    if err != 0:
        raise RuntimeError(
            f"flash_attention kernel launch failed: CUDA error {err} "
            f"({lib.qappa_error_string(err).decode()})")
    launches += 1
    launches_windowed += window is not None
    if tc:
        launches_tc += 1
    else:
        launches_f32 += 1
    return out


def _decode(q, k, v, causal, window, scale) -> torch.Tensor:
    """:func:`flash_attention`'s decode regime (checked operands on one
    CUDA device)."""
    global launches, launches_decode, launches_windowed, last_grid
    b, h, sq, d = q.shape
    kvh, sk = k.shape[1], k.shape[2]
    es = q.element_size()
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1 or t.data_ptr() % 16 \
                or any(s * es % 16 for s in t.stride()[:3]):
            raise ValueError(
                f"flash_attention: the decode regime reads 16-byte aligned "
                f"rows with d contiguous; {name} has strides {t.stride()} "
                f"and starts at {t.data_ptr() % 16} mod 16")
    p = decode_plan(b, h, kvh, sq, sk, d, q.dtype, causal=causal,
                    window=window)
    from repro_torch.kernels import _build
    lib = _build.library("flash_decode" if q.dtype == torch.bfloat16
                         else "flash_decode_f32")
    with torch.cuda.device(q.device):
        out = torch.empty((b, sq, h, d), dtype=q.dtype,
                          device=q.device).transpose(1, 2)
        stream = current_stream(q.device)
        scratch = torch.empty(p.scratch, dtype=torch.float32,
                              device=q.device)
        ws = workspace(q.device, p.workspace, stream)
        strides = (ctypes.c_longlong * 12)(
            *(s for t in (q, k, v, out) for s in t.stride()[:3]))
        info = (ctypes.c_int * 4)()
        err = lib.qappa_flash_decode(
            *(ctypes.c_void_p(t.data_ptr()) for t in (q, k, v, out)),
            strides, ctypes.c_void_p(scratch.data_ptr()), p.scratch,
            ctypes.c_void_p(ws.data_ptr()), ws.numel(), b, h, kvh, sq, sk,
            d, int(causal),
            0 if window is None else min(int(window), _INT_MAX),
            ctypes.c_float(_scale(d, scale)), p.key_lo, p.split_keys, p.rt,
            p.slices, info, ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(
            f"flash_attention decode kernel launch failed: CUDA error {err} "
            f"({lib.qappa_error_string(err).decode()})")
    last_grid = (info[1], info[2])
    launches += 1
    launches_decode += 1
    launches_windowed += window is not None
    return out
