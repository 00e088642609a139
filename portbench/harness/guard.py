"""The run's own limits: where it may write, which card it runs on, and
which modules it may hold."""

from __future__ import annotations

import os
import pathlib
import sys

#: top-level module names a run may not hold once its window has closed:
#: JAX and the JAX package the port was made from
FORBIDDEN_MODULES = frozenset({"jax", "jaxlib", "flax", "repro"})
#: build and kernel caches, each at a fixed path inside the checkout
CACHE_VARS = ("TRITON_CACHE_DIR", "TORCH_EXTENSIONS_DIR",
              "TORCHINDUCTOR_CACHE_DIR", "CUDA_CACHE_PATH")


class NoDevice(RuntimeError):
    """The run found fewer cards than its cell asks for."""


def pin_caches(root: pathlib.Path) -> None:
    """Point every build and kernel cache at its fixed directory under
    ``root/.portbench_cache`` (the program's own kernel builds go to its
    ``src/repro_torch/kernels/build``, also inside the checkout)."""
    base = root / ".portbench_cache"
    for var in CACHE_VARS:
        path = base / var.lower()
        path.mkdir(parents=True, exist_ok=True)
        os.environ[var] = str(path)


def require_cards(n: int):
    """The device of a run on ``n`` cards; raises :class:`NoDevice`
    where CUDA is not available or fewer cards are visible."""
    import torch
    if not torch.cuda.is_available():
        raise NoDevice("torch.cuda.is_available() is false: the benchmark "
                       "runs only on the card")
    if torch.cuda.device_count() < n:
        raise NoDevice(f"the cell asks for {n} cards, "
                       f"{torch.cuda.device_count()} visible")
    return torch.device("cuda", 0)


def forbidden_modules(modules=None) -> list:
    """The forbidden top-level names among ``modules`` (``sys.modules``
    by default), each name compared whole: ``repro_torch`` is not
    ``repro``."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".", 1)[0] for m in names} & FORBIDDEN_MODULES)
