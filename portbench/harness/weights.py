"""The float weights of a run, drawn on the device from the seed.

Both sides get them from here: the port, which quantizes them in its
set-up, and the reference, which draws the same ones again after the
window.  Each layer is one ``randn`` call on a generator of its own, so
a layer can be drawn again without the layers before it.  Scales as the
port's ``Model.init`` draws them: ``N(0, 0.02^2)``, the output
projections ``wo`` and ``w_down`` at ``0.02 / sqrt(2 L)``; norms are
ones.  Weights are float32, the type the port's model holds before it
quantizes them.
"""

from __future__ import annotations

import math

import torch

from portbench.harness.spec import ModelShape
from portbench.harness.traffic import torch_seed

#: the projections drawn at the output scale
OUT_PROJ = ("wo", "w_down")


def _generator(seed: int, stream: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(torch_seed(seed, stream))
    return g


def embedding(shape: ModelShape, seed: int, device) -> torch.Tensor:
    """The (vocab, d) float32 embedding, also the logits' projection."""
    return torch.randn((shape.vocab, shape.d_model),
                       generator=_generator(seed, 100, device),
                       device=device).mul_(0.02)


def layer(shape: ModelShape, seed: int, index: int, device) -> dict:
    """Layer ``index``'s float32 weights: each projection (d_in, d_out)
    a view of one buffer drawn in one call, and the norms ``ln1``,
    ``ln2``."""
    sizes = [(name, din, dout) for name, din, dout in shape.projections]
    flat = torch.randn((sum(i * o for _, i, o in sizes),),
                       generator=_generator(seed, 1000 + index, device),
                       device=device)
    out_scale = 0.02 / max(1.0, math.sqrt(2 * shape.n_layers))
    lp, at = {}, 0
    for name, din, dout in sizes:
        w = flat[at:at + din * dout].view(din, dout)
        w.mul_(out_scale if name in OUT_PROJ else 0.02)
        lp[name] = w
        at += din * dout
    ones = torch.ones((shape.d_model,), dtype=torch.float32, device=device)
    lp["ln1"], lp["ln2"] = ones, ones.clone()
    return lp
