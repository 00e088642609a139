"""Carry the reference model's params over to the port.

The reference (``repro.models.model.Model``) keeps its layers stacked on
a leading axis; the port keeps a list of per-layer dicts.  The caller
hands the reference's params over as nested dicts of numpy arrays (the
port never sees a JAX type), with each quantized leaf as a dict
``{"data", "scale", "mode", "orig_shape"}`` whose arrays keep the stacked
``(L, ...)`` axis.  The hybrid's ``shared`` block is not stacked: its
leaves (quantized ones 2-D) are carried over as they are.  The vlm and
audio families' stacked ``cross_layers`` and the audio family's
``encoder_layers`` become lists as ``layers`` does.

:func:`from_reference_cache` carries a reference decode-cache dict over
the same way: the port's caches have the reference's keys, shapes and
dtypes, so that a test can start both models from one cache state and
compare every cache after each step.  A bfloat16 array (numpy's
extension type from JAX) is carried bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.device import resolve_device
from repro_torch.quant.qlinear import QuantizedTensor

QUANTIZED_KEYS = {"data", "scale", "mode", "orig_shape"}
MAMBA_KEYS = {"ln1", "in_proj", "conv_w", "dt_bias", "a_log", "d_skip",
              "out_proj"}
MOE_KEYS = {"ln1", "ln2", "wq", "wk", "wv", "wo", "router",
            "w_experts_gate", "w_experts_in", "w_experts_out"}
CROSS_KEYS = {"ln_x", "wq_x", "wk_img", "wv_img", "wo_x"}


def _tensor(a, device) -> torch.Tensor:
    # a copy: arrays handed over from JAX are read-only
    a = np.array(a, order="C")
    if a.dtype.name == "bfloat16":      # no numpy type: carry the bits
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16) \
            .to(device)
    return torch.from_numpy(a).to(device)


def _leaf(leaf, l: int | None, device):
    """A leaf, sliced at layer ``l`` (unsliced when ``l`` is None)."""
    def part(a):
        return a if l is None else a[l]
    if isinstance(leaf, dict):
        if set(leaf) != QUANTIZED_KEYS:
            raise ValueError(
                f"a quantized leaf has keys {sorted(QUANTIZED_KEYS)}, got "
                f"{sorted(leaf)}")
        return QuantizedTensor(_tensor(part(leaf["data"]), device),
                               _tensor(part(leaf["scale"]), device),
                               str(leaf["mode"]), tuple(leaf["orig_shape"]))
    return _tensor(part(leaf), device)


def _block_keys(cfg: ArchConfig) -> set:
    """The keys of a dense layer or of the hybrid's shared block."""
    keys = {"ln1", "ln2", "wq", "wk", "wv", "wo", "w_up", "w_down"}
    return keys | {"w_gate"} if cfg.mlp_kind == "swiglu" else keys


def _check_keys(what: str, got, want: set) -> None:
    if set(got) != want:
        raise ValueError(f"{what}: keys {sorted(got)}, expected "
                         f"{sorted(want)}")


def _unstack(what: str, stacked: dict, keys: set, n: int, dev) -> list:
    """A stack of ``n`` layers with ``keys`` -> one dict per layer."""
    _check_keys(what, stacked, keys)
    lengths = {len(v["data"] if isinstance(v, dict) else v)
               for v in stacked.values()}
    if lengths != {n}:
        raise ValueError(f"{what}: stacked layer axes of lengths "
                         f"{sorted(lengths)}, expected {n}")
    return [{name: _leaf(leaf, l, dev) for name, leaf in stacked.items()}
            for l in range(n)]


def from_reference_params(cfg: ArchConfig, tree: dict, *,
                          device="cuda") -> dict:
    """The reference's params of a model of any family -> the port's
    params on ``device``: ``embed`` and ``final_norm`` as tensors,
    ``layers`` (and the vlm / audio ``cross_layers``, the audio
    ``encoder_layers``) sliced into one dict per layer, the hybrid's
    ``shared`` unsliced.  Raises on a tree whose keys are not the
    family's."""
    dev = resolve_device(device)
    layer_keys = {"dense": _block_keys(cfg), "moe": MOE_KEYS,
                  "ssm": MAMBA_KEYS, "hybrid": MAMBA_KEYS,
                  "vlm": _block_keys(cfg),
                  "audio": _block_keys(cfg)}.get(cfg.family)
    if layer_keys is None:
        raise NotImplementedError(
            f"{cfg.name}: no model family {cfg.family!r}")
    extra = {"hybrid": {"shared"}, "vlm": {"cross_layers"},
             "audio": {"cross_layers", "encoder_layers"}}
    _check_keys(f"{cfg.name} params", tree, {"embed", "final_norm", "layers"}
                | extra.get(cfg.family, set()))
    out = {"embed": _tensor(tree["embed"], dev),
           "final_norm": _tensor(tree["final_norm"], dev),
           "layers": _unstack(f"{cfg.name} layers", tree["layers"],
                              layer_keys, cfg.n_layers, dev)}
    if "cross_layers" in tree:
        n_cross = cfg.n_layers // cfg.cross_attn_every \
            if cfg.family == "vlm" else cfg.n_layers
        out["cross_layers"] = _unstack(f"{cfg.name} cross layers",
                                       tree["cross_layers"], CROSS_KEYS,
                                       n_cross, dev)
    if "encoder_layers" in tree:
        out["encoder_layers"] = _unstack(
            f"{cfg.name} encoder layers", tree["encoder_layers"],
            _block_keys(cfg), cfg.encoder_layers, dev)
    if cfg.family == "hybrid":
        _check_keys(f"{cfg.name} shared block", tree["shared"],
                    _block_keys(cfg))
        out["shared"] = {name: _leaf(leaf, None, dev)
                         for name, leaf in tree["shared"].items()}
    return out


def from_reference_cache(model, tree: dict, *, device="cuda") -> dict:
    """A dense, moe, vlm or audio model's reference decode-cache dict
    (numpy arrays, bfloat16 ones too; the vlm and audio ones with their
    context caches ``ctx_k``, ``ctx_v``) -> the port's caches on
    ``device``.  Raises unless the keys, shapes and dtypes are those of
    ``model.init_cache`` for the batch, length and ``kv_quant`` of its
    ``k``."""
    if model.cfg.family not in ("dense", "moe", "vlm", "audio") \
            or "k" not in tree:
        raise ValueError(f"{model.cfg.name}: a dense, moe, vlm or audio "
                         f"model's cache with k and v, got keys "
                         f"{sorted(tree)}")
    dev = resolve_device(device)
    out = {name: _tensor(a, dev) for name, a in tree.items()}
    k = out["k"]
    int8 = k.dtype == torch.int8
    want = model.init_cache(k.shape[1], k.shape[2],
                            dtype=torch.bfloat16 if int8 else k.dtype,
                            kv_quant=int8)
    _check_keys(f"{model.cfg.name} cache", out, set(want))
    for name, t in out.items():
        if t.shape != want[name].shape or t.dtype != want[name].dtype:
            raise ValueError(
                f"{model.cfg.name} cache {name}: {tuple(t.shape)} "
                f"{t.dtype}, expected {tuple(want[name].shape)} "
                f"{want[name].dtype}")
    return out
