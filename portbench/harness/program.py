"""The system under test: ``repro_torch``'s ``Model`` built from a
configuration, with the benchmark's float weights quantized by the
port's ``Model.quantize_params`` one layer at a time."""

from __future__ import annotations

import torch

from portbench.harness import weights
from portbench.harness.spec import ModelShape


def arch_config(shape: ModelShape):
    """The port's ``ArchConfig`` of a configuration."""
    from repro_torch.configs.base import ArchConfig
    return ArchConfig(
        name=shape.name, family="dense", n_layers=shape.n_layers,
        d_model=shape.d_model, n_heads=shape.n_heads,
        n_kv_heads=shape.n_kv_heads, d_ff=shape.d_ff, vocab=shape.vocab,
        head_dim=shape.head_dim, mlp_kind=shape.mlp,
        rope_theta=shape.rope_theta, quant=shape.quant)


def build(shape: ModelShape, seed: int, device, impl: str = "auto"):
    """``(model, params)``: the port's model on ``device`` and its params,
    each layer drawn from the seed and quantized before the next is
    drawn.  ``impl`` "auto" runs the CUDA kernels on the card and their
    plain versions on the CPU; "ref" the plain versions on either."""
    from repro_torch.models.model import Model
    model = Model(arch_config(shape), device=device, impl=impl)
    layers = []
    for index in range(shape.n_layers):
        lp = weights.layer(shape, seed, index, device)
        layers.append(model.quantize_params({"layers": [lp]})["layers"][0])
        del lp
    params = {"embed": weights.embedding(shape, seed, device),
              "final_norm": torch.ones((shape.d_model,), device=device),
              "layers": layers}
    return model, params


def serve(model, params, tokens: torch.Tensor) -> torch.Tensor:
    """One request: the prompt ``tokens`` (s,) -> the last position's
    logits, enqueued on the device (not yet on the host)."""
    logits, _ = model.forward(params, tokens.view(1, -1), last_only=True)
    return logits[0, -1]
