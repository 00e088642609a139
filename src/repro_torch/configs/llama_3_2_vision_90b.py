"""llama-3.2-vision-90b [vlm] — cross-attn image layers
[hf:meta-llama/Llama-3.2-11B-Vision].  Backbone only; the vision frontend
is a stub (input_specs provides precomputed patch embeddings)."""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="llama-3.2-vision-90b", family="vlm",
    n_layers=100, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=28672, vocab=128256, cross_attn_every=5,
    n_ctx_tokens=1601, quant="w8a8",
))
