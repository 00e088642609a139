"""W8A8 decode attention: one GQA decode step over an int8 KV cache.

Replaces the Pallas TPU kernel ``repro/kernels/w8a8_decode.py``
(``_kernel``, built around its ``pl.pallas_call`` in
``w8a8_decode_attention``) with a CUDA kernel written for Hopper,
``csrc/w8a8_decode.cu``; its header says what bounds it and how it is
laid out.

The function is split in two:

* :func:`quantize_q` quantizes q per row to int8 and gives each row's
  logit factor ``q_s * hd^-0.5``, in float32, as the TPU kernel does
  inside its body.  The model's int8-KV branch computes its own codes and
  factor in bf16 (``models/attention.py``) and calls the body directly:
  the two q quantizations of the reference differ, and the body serves
  both.
* the **body** takes q codes ``(b, kvh, rep, hd)`` int8, the factor
  ``(b, kvh, rep)`` float32, K and V ``(b, S, kvh, hd)`` int8 with their
  scales ``(b, S, kvh)`` float32, and one position per batch row
  ``(b,)`` int32 on the device (past = ``[0, pos]``).  It computes
  everything the TPU kernel does after quantizing q: the int8 QK^T, the
  logits ``(float(qk) * factor) * k_scale`` masked to -1e30 beyond
  ``pos``, the softmax numerator ``exp(logit - max)``, the v-scales
  folded into it, the probabilities quantized per row per block of
  ``bs`` keys, the int8 PV, ``(pv * p_s)`` summed over blocks, and the
  division by ``l`` at the end.

The softmax is taken against the row's global maximum (the oracle's form,
``ref.w8a8_decode_attention_ref``), not the TPU kernel's running maximum;
the two differ only by rounding.  ``l`` is summed in float64 and then
rounded to float32, so its value does not depend on the summation order:
kernel and plain version then compute the same numbers in the same order
and agree bit for bit (every integer sum is exact in both).

The kernel splits S across blocks (:func:`plan`) and runs in three
launches a call on one stream (logits, exp, PV and epilogue); the splits
meet through a scratch buffer and the persistent zeroed workspace of the
current stream (``kernels/_workspace.py``, shared with the W8A8 split-k
regime), which the kernel leaves zeroed.  The
cross-split steps keep the plain version's float order: the row max and
the probability scale of a block of ``bs`` keys are maxima (order-free),
``l`` meets as float64 partials, the int32 PV sums meet by integer atomics
(exact), and the float32 ``acc`` is summed in block order by the split
that arrives last.

The plain versions (:func:`w8a8_decode_attention_body_ref`,
:func:`w8a8_decode_attention_ref`) take the integer products in float64,
exact for these sums, and run on any device.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch

from repro_torch.kernels._workspace import workspace
from repro_torch.quant.quantizers import const_like

NEG_INF = -1e30
#: the kernel keeps up to this many query rows per kv head in registers
MAX_REP = 16
#: and stages up to this head dim in shared memory
MAX_HEAD_DIM = 256
#: the int32 PV sum of one block, bs * 127 * 127, stays below 2^31
MAX_BLOCK = (2 ** 31 - 1) // (127 * 127)

#: blocks the split aims for: two per SM of an H100 (132 SMs)
SPLIT_TARGET_BLOCKS = 264
#: keys a split walks at most, and at least (before alignment)
SPLIT_MAX_KEYS = 2048
SPLIT_MIN_KEYS = 64
#: calls of the kernel since the counters were last set to 0, and the
#: kernel launches those calls made on the card, as the C entry reports
#: them (three a call: logits, exp, PV)
launches = 0
kernel_launches = 0
#: the grid of the last call, (b * kvh, splits), as the C entry launched it
last_grid = None


class Plan(NamedTuple):
    """How one call runs: ``splits`` of S, ``split_keys`` keys each (the
    last the rest), ``blocks`` of the grid (``b * kvh * splits``), and the
    buffers' sizes the C entry checks: ``scratch`` float32 (float64 ``l``
    partials, logits, split maxima and, with more than one ``bs`` block,
    the blocks' float32 terms) and ``workspace`` int32 (``rep * hd`` PV
    sums and one arrival counter per (b, kv head))."""
    splits: int
    split_keys: int
    blocks: int
    scratch: int
    workspace: int


def plan(b: int, kvh: int, rep: int, hd: int, S: int, bs: int) -> Plan:
    """The split of S for one call.

    Enough splits that the grid has ``SPLIT_TARGET_BLOCKS`` blocks and no
    split walks more than ``SPLIT_MAX_KEYS`` keys, none shorter than
    ``SPLIT_MIN_KEYS`` where S allows; the split length a multiple of 4
    and, where ``bs < S``, of ``bs``, so that a ``bs`` block never
    straddles two splits (with ``bs = S`` the one block spans them all and
    its probability scale is a maximum over the splits)."""
    bg = b * kvh
    want = max(-(-SPLIT_TARGET_BLOCKS // bg), -(-S // SPLIT_MAX_KEYS))
    align = 4 if bs >= S else bs * 4 // math.gcd(bs, 4)
    keys = max(-(-S // want), SPLIT_MIN_KEYS)
    keys = -(-keys // align) * align
    splits = -(-S // keys)
    nb = S // bs
    scratch = bg * (4 * splits * rep + rep * S
                    + (nb * rep * hd if nb > 1 else 0))
    return Plan(splits, keys, bg * splits, scratch, bg * rep * hd + bg)


def positions(pos, b: int, device) -> torch.Tensor:
    """``pos`` (an int, a 0-d or a ``(b,)`` tensor) as a ``(b,)`` int32
    tensor on ``device``; a scalar is broadcast, nothing syncs."""
    if isinstance(pos, torch.Tensor):
        if pos.dim() == 0:
            return pos.to(device=device, dtype=torch.int32).expand(b) \
                .contiguous()
        if tuple(pos.shape) != (b,):
            raise ValueError(
                f"pos must be a scalar or have shape ({b},), got "
                f"{tuple(pos.shape)}")
        return pos.to(device=device, dtype=torch.int32).contiguous()
    return torch.full((b,), int(pos), dtype=torch.int32, device=device)


def quantize_q(q: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The TPU kernel's q quantization, in float32: codes
    ``round(q / max(q_s, 1e-8))`` with ``q_s = max|q| / 127`` per row, and
    the logit factor ``q_s * hd^-0.5`` ``(b, kvh, rep)``."""
    qf = q.to(torch.float32)
    q_s = qf.abs().amax(dim=-1, keepdim=True) / const_like(127.0, qf)
    q_q = torch.round(qf / q_s.clamp_min(1e-8)).clamp(-128, 127) \
        .to(torch.int8)
    return q_q, (q_s * float(q.shape[-1]) ** -0.5)[..., 0]


def check_operands(q_q, factor, k_q, v_q, k_scale, v_scale, pos, bs: int):
    """Validate the body's operands; returns ``(b, kvh, rep, hd, S)``."""
    if q_q.dim() != 4 or k_q.dim() != 4:
        raise ValueError(
            f"w8a8_decode_attention: q (b, kvh, rep, hd) and K/V "
            f"(b, S, kvh, hd), got {tuple(q_q.shape)} and "
            f"{tuple(k_q.shape)}")
    b, kvh, rep, hd = q_q.shape
    S = k_q.shape[1]
    if not 1 <= bs <= MAX_BLOCK:
        raise ValueError(
            f"block size bs={bs} outside [1, {MAX_BLOCK}]: the int32 PV "
            f"sum of a block, bs * 127 * 127, must stay below 2^31")
    # ValueError, as the TPU entry raises: a ragged S would drop keys
    if S % bs:
        raise ValueError(
            f"kv sequence length S={S} must be divisible by the block "
            f"size bs={bs}; pad the cache or pick a divisible bs")
    want = {"k_q": (b, S, kvh, hd), "v_q": (b, S, kvh, hd),
            "k_scale": (b, S, kvh), "v_scale": (b, S, kvh),
            "factor": (b, kvh, rep), "pos": (b,)}
    got = {"k_q": k_q, "v_q": v_q, "k_scale": k_scale, "v_scale": v_scale,
           "factor": factor, "pos": pos}
    for name, t in got.items():
        if tuple(t.shape) != want[name]:
            raise ValueError(
                f"w8a8_decode_attention: {name} has shape "
                f"{tuple(t.shape)}, expected {want[name]}")
    dtypes = {"q_q": (q_q, torch.int8), "k_q": (k_q, torch.int8),
              "v_q": (v_q, torch.int8), "factor": (factor, torch.float32),
              "k_scale": (k_scale, torch.float32),
              "v_scale": (v_scale, torch.float32),
              "pos": (pos, torch.int32)}
    for name, (t, dt) in dtypes.items():
        if t.dtype != dt:
            raise ValueError(
                f"w8a8_decode_attention: {name} must be {dt}, got {t.dtype}")
        if t.device != q_q.device:
            raise ValueError(
                f"w8a8_decode_attention: {name} on {t.device}, q on "
                f"{q_q.device}")
    return b, kvh, rep, hd, S


def w8a8_decode_attention_body_ref(q_q, factor, k_q, v_q, k_scale, v_scale,
                                   pos, *, bs: int,
                                   out_dtype=torch.float32,
                                   keep=None) -> torch.Tensor:
    """The plain version of the body (see the module docstring).
    ``keep``: an optional (b, S) bool mask of the keys kept besides
    ``s <= pos`` (the model's dynamic decode window); the kernel has
    none."""
    b, kvh, rep, hd, S = check_operands(q_q, factor, k_q, v_q, k_scale,
                                        v_scale, pos, bs)
    li = torch.einsum("bgrd,bsgd->bgrs", q_q.to(torch.float64),
                      k_q.to(torch.float64)).to(torch.int32)
    logits = li.to(torch.float32) * factor[..., None] \
        * k_scale.transpose(1, 2)[:, :, None, :]
    ki = torch.arange(S, device=q_q.device)
    valid = ki[None, :] <= pos.to(torch.int64)[:, None]
    if keep is not None:
        valid = valid & keep
    valid = valid[:, None, None, :]
    logits = torch.where(valid, logits, NEG_INF)
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.exp(logits - m)
    l = p.to(torch.float64).sum(dim=-1).to(torch.float32)     # (b,g,r)
    pf = p * v_scale.transpose(1, 2)[:, :, None, :]
    nb = S // bs
    pb = pf.reshape(b, kvh, rep, nb, bs)
    p_s = pb.amax(dim=-1, keepdim=True) / const_like(127.0, pb)
    p_q = torch.round(pb / p_s.clamp_min(1e-12))
    vb = v_q.transpose(1, 2).reshape(b, kvh, nb, bs, hd)
    oi = torch.einsum("bgrcs,bgcsd->bgrcd", p_q.to(torch.float64),
                      vb.to(torch.float64)).to(torch.int32)
    acc = torch.zeros((b, kvh, rep, hd), dtype=torch.float32,
                      device=q_q.device)
    for c in range(nb):      # block order, as the kernel adds them
        acc = acc + oi[:, :, :, c].to(torch.float32) * p_s[:, :, :, c]
    return (acc / l.clamp_min(1e-30)[..., None]).to(out_dtype)


def w8a8_decode_attention_ref(q, k_q, v_q, k_scale, v_scale, pos, *,
                              bs: int = 512) -> torch.Tensor:
    """The plain version of the TPU entry point: q ``(b, kvh, rep, hd)``
    float, ``pos`` an int or a ``(b,)`` tensor; out in q's dtype."""
    q_q, factor = quantize_q(q)
    return w8a8_decode_attention_body_ref(
        q_q, factor, k_q, v_q, k_scale, v_scale,
        positions(pos, q.shape[0], q.device), bs=bs, out_dtype=q.dtype)


def w8a8_decode_attention_body(q_q, factor, k_q, v_q, k_scale, v_scale,
                               pos, *, bs: int,
                               out_dtype=torch.float32) -> torch.Tensor:
    """The CUDA kernel of the body; every operand contiguous on one CUDA
    device.  Positions are read on the device: ``0 <= pos`` (keys beyond
    ``pos`` are never read, so a position past ``S - 1`` reads them
    all).  Raises on a CPU tensor, a failed build or a failed launch."""
    global launches, kernel_launches, last_grid
    b, kvh, rep, hd, S = check_operands(q_q, factor, k_q, v_q, k_scale,
                                        v_scale, pos, bs)
    device = q_q.device
    if device.type != "cuda":
        raise ValueError(
            f"w8a8_decode_attention: the kernel takes CUDA tensors, got "
            f"{device}; the plain version runs on the CPU (ops "
            f"impl='auto' or 'ref')")
    if hd % 4 or hd > MAX_HEAD_DIM or rep > MAX_REP:
        raise ValueError(
            f"w8a8_decode_attention: the kernel needs hd % 4 == 0 (dp4a), "
            f"hd <= {MAX_HEAD_DIM} and rep <= {MAX_REP}, got hd={hd}, "
            f"rep={rep}")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(
            f"w8a8_decode_attention: out_dtype float32 or bfloat16, got "
            f"{out_dtype}")
    for t in (q_q, factor, k_q, v_q, k_scale, v_scale, pos):
        if not t.is_contiguous():
            raise ValueError("w8a8_decode_attention: operands must be "
                             "contiguous")
    from repro_torch.kernels import _build
    lib = _build.library("w8a8_decode")
    p = plan(b, kvh, rep, hd, S, bs)
    with torch.cuda.device(device):
        scratch = torch.empty(p.scratch, dtype=torch.float32, device=device)
        ws = workspace(device, p.workspace)
        out = torch.empty((b, kvh, rep, hd), dtype=out_dtype, device=device)
        info = (ctypes.c_int * 3)()
        ptr = [ctypes.c_void_p(t.data_ptr()) for t in (
            q_q, factor, k_q, v_q, k_scale, v_scale, pos, out, scratch)]
        err = lib.qappa_w8a8_decode(
            *ptr, scratch.numel(), ctypes.c_void_p(ws.data_ptr()), ws.numel(),
            int(out_dtype == torch.bfloat16), b, kvh, rep, hd, S, bs,
            p.split_keys, info,
            ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream))
    kernel_launches += info[0]
    last_grid = (info[1], info[2])
    if err != 0:
        raise RuntimeError(
            f"w8a8_decode_attention kernel launch failed: CUDA error {err} "
            f"({lib.qappa_error_string(err).decode()})")
    launches += 1
    return out


def w8a8_decode_attention(q, k_q, v_q, k_scale, v_scale, pos, *,
                          bs: int = 512) -> torch.Tensor:
    """The TPU entry point on the kernel: q quantized in float32
    (:func:`quantize_q`), then the body; out in q's dtype."""
    q_q, factor = quantize_q(q)
    kernel_dtype = q.dtype if q.dtype in (torch.float32, torch.bfloat16) \
        else torch.float32
    out = w8a8_decode_attention_body(
        q_q, factor, k_q, v_q, k_scale, v_scale,
        positions(pos, q.shape[0], q.device), bs=bs, out_dtype=kernel_dtype)
    return out.to(q.dtype)
