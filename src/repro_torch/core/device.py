"""Device resolution for the port's entry points.

The counterpart of :func:`repro.core.dse_batch.resolve_backend`'s refusal:
an entry point runs on the card unless the caller asks for the CPU, and a
request for CUDA on a host without it raises instead of carrying on
somewhere else.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """``"cpu"`` or ``"cuda"`` / ``"cuda:i"`` as a :class:`torch.device`;
    raises ``RuntimeError`` for CUDA when no card is usable."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(
            f"unsupported device {device!r}: the port runs on 'cuda' or "
            f"'cpu'")
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but CUDA is not available "
            f"(torch {torch.__version__}); pass device='cpu' to run the "
            f"exact CPU path")
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev
