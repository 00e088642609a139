"""int8 gradient compression with error feedback: the port of
:mod:`repro.parallel.compression` on the port's param trees.

QAPPA's low-bit idea applied to the gradients: each is quantized to int8
with one symmetric scale, and the quantization residual is carried to
the next step (error feedback, 1-bit-Adam style), so the cumulative
compressed gradient stays within one step's quantization error of the
raw one.  The train step applies :func:`compress_roundtrip` on whatever
mesh it runs under (:func:`repro_torch.launch.train.make_train_step`),
as the reference's does: neither package sends the int8 codes through a
data-parallel all-reduce.  On a placed tree (``DTensor`` leaves) each
code, output and residual keeps its leaf's placements, and a split
leaf's maximum is all-reduced before its scale is taken: a maximum is
exact, so the placed round trip is the unplaced one bit for bit.

**One scale per leaf of the reference's stacked tree.**  The reference
takes ``max|g + e|`` over each leaf of its tree, where a per-layer
weight is one ``(L, ...)`` array: one scale covers all L layers.  The
port keeps a list of per-layer dicts, so it takes the maximum over every
layer of each key of ``layers``, ``cross_layers`` and
``encoder_layers`` (the grouping of :func:`repro_torch.optim.adamw.leaves`)
and puts that one scale in each layer's slot of the scales tree; the
hybrid's unstacked ``shared`` block keeps one scale per leaf.  A
maximum is exact in any order, so the scales, and with them the codes,
are the reference's bit for bit.
"""

from __future__ import annotations

import torch

from repro_torch.models.tree import tree_map
from repro_torch.optim.adamw import leaves, zeros_f32
from repro_torch.parallel.sharding import reduce_partial
from repro_torch.quant import quantizers as qz

BITS = 8


def init_error_state(params):
    """float32 zeros placed as each param (``adamw.zeros_f32``)."""
    return tree_map(zeros_f32, params)


def _scales(gf) -> dict[int, torch.Tensor]:
    """The int8 scale of each leaf of ``gf`` by ``id``: one per stacked
    key, shared by its layers."""
    groups: dict[str, list] = {}
    for path, g, stacked in leaves(gf):
        if stacked:                      # ".../layers/<l>/<name>"
            head, _, name = path.rsplit("/", 2)
            path = f"{head}/{name}"
        groups.setdefault(path, []).append(g)
    out = {}
    for members in groups.values():
        # the absmax of the layers' absmaxes: the stack's, exactly (a
        # split leaf's maximum all-reduced over the mesh first)
        scale = qz.int_scale(torch.stack(
            [reduce_partial(g.abs().amax()) for g in members]), BITS)
        out.update((id(g), scale) for g in members)
    return out


def compress_grads(grads, err_state):
    """Returns (int8 grads tree, scales tree, new error-feedback tree), the
    trees in the port's layout (a stacked key's scale in each layer's
    slot)."""
    gf = tree_map(lambda g, e: g.to(torch.float32) + e, grads, err_state)
    scale = _scales(gf)
    scales = tree_map(lambda g: scale[id(g)], gf)
    qs = tree_map(lambda g, s: qz.quantize_int(g, s, BITS), gf, scales)
    errs = tree_map(lambda g, q, s: g - qz.dequantize_int(q, s),
                    gf, qs, scales)
    return qs, scales, errs


def decompress_grads(qgrads, scales):
    return tree_map(qz.dequantize_int, qgrads, scales)


def compress_roundtrip(grads, err_state):
    """One-step compress+decompress (what each step applies)."""
    qg, scales, err = compress_grads(grads, err_state)
    return decompress_grads(qg, scales), err
