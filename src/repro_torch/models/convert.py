"""Carry the reference model's params over to the port.

The reference (``repro.models.model.Model``) keeps its layers stacked on
a leading axis; the port keeps a list of per-layer dicts.  The caller
hands the reference's params over as nested dicts of numpy arrays (the
port never sees a JAX type), with each quantized leaf as a dict
``{"data", "scale", "mode", "orig_shape"}`` whose arrays keep the stacked
``(L, ...)`` axis.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.device import resolve_device
from repro_torch.quant.qlinear import QuantizedTensor

QUANTIZED_KEYS = {"data", "scale", "mode", "orig_shape"}


def _tensor(a, device) -> torch.Tensor:
    # a copy: arrays handed over from JAX are read-only
    return torch.from_numpy(np.array(a, order="C")).to(device)


def _leaf(leaf, l: int, device):
    if isinstance(leaf, dict):
        if set(leaf) != QUANTIZED_KEYS:
            raise ValueError(
                f"a quantized leaf has keys {sorted(QUANTIZED_KEYS)}, got "
                f"{sorted(leaf)}")
        return QuantizedTensor(_tensor(leaf["data"][l], device),
                               _tensor(leaf["scale"][l], device),
                               str(leaf["mode"]), tuple(leaf["orig_shape"]))
    return _tensor(leaf[l], device)


def from_reference_params(cfg: ArchConfig, tree: dict, *,
                          device="cuda") -> dict:
    """The reference's dense-model params -> the port's params on
    ``device``: ``embed`` and ``final_norm`` as tensors, ``layers`` sliced
    into one dict per layer."""
    dev = resolve_device(device)
    layers = tree["layers"]
    n = {len(v["data"] if isinstance(v, dict) else v)
         for v in layers.values()}
    if n != {cfg.n_layers}:
        raise ValueError(
            f"{cfg.name}: stacked layer axes of lengths {sorted(n)}, "
            f"expected {cfg.n_layers}")
    return {"embed": _tensor(tree["embed"], dev),
            "final_norm": _tensor(tree["final_norm"], dev),
            "layers": [{name: _leaf(leaf, l, dev)
                        for name, leaf in layers.items()}
                       for l in range(cfg.n_layers)]}
