"""The persistent zeroed int32 workspace that split kernels meet in.

Three kernels split one output's work across blocks and add their
integer partial sums by atomics into a buffer that must be zero when they
start: W8A8's split-k regime (``w8a8_matmul``), the W4A8 split-k kernel
(``w4a8_matmul``) and decode attention's split of S (``w8a8_decode``).
All take the buffer from :func:`workspace` and all keep one rule: **a
kernel zeroes every word it used before it returns** (the last block to
arrive at a tile re-zeroes its sums and its arrival counter), so the
buffer is zero between calls and needs no clearing launch.  Calls on one
stream run one after another, so the kernels can share a stream's
buffer; each stream has its own, so
calls on two streams at once never add into one another's sums.
"""

from __future__ import annotations

import torch

_WORKSPACE: dict = {}     # (device, stream) -> zeroed int32 workspace


def current_stream(device: torch.device) -> int:
    """The handle of ``device``'s current CUDA stream, without building a
    ``torch.cuda.Stream`` object (a few µs a call on the launch path)."""
    return torch._C._cuda_getCurrentRawStream(device.index)


def workspace(device: torch.device, size: int,
              stream: int | None = None) -> torch.Tensor:
    """The persistent workspace of ``device``'s current stream, at least
    ``size`` int32, all zero between calls.  Zeroed once per stream, and
    again only when it grows, on that stream.  ``stream``: the current
    stream's handle, where the caller has it already."""
    if stream is None and device.type == "cuda":
        stream = current_stream(device)
    key = (device, stream)
    buf = _WORKSPACE.get(key)
    if buf is None or buf.numel() < size:
        buf = torch.zeros(max(size, 2 ** 16), dtype=torch.int32,
                          device=device)
        _WORKSPACE[key] = buf
    return buf
