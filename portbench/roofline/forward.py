"""The calls of one dense prefill forward (b = 1, one prompt of ``s``
tokens, the last position's logits), from the model's shape alone."""

from __future__ import annotations

from portbench.harness.spec import ModelShape


def projections(shape: ModelShape, s: int) -> list[tuple[int, int, int]]:
    """``(m, k, n)`` of each quantized projection of the forward, layer
    by layer."""
    return [(s, din, dout) for _ in range(shape.n_layers)
            for _, din, dout in shape.projections]


def attentions(shape: ModelShape, s: int) -> list[tuple[int, int, int, int]]:
    """``(s, heads, kv_heads, head_dim)`` of each causal self-attention."""
    return [(s, shape.n_heads, shape.n_kv_heads, shape.head_dim)] \
        * shape.n_layers


def logits_flops(shape: ModelShape) -> float:
    """The last position's logits: one (1, d) x (d, vocab) product."""
    return 2.0 * shape.d_model * shape.vocab
