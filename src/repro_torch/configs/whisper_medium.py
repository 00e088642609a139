"""whisper-medium [audio] — enc-dec, conv frontend (stub)
[arXiv:2212.04356].  Backbone only; input_specs provides precomputed
frame embeddings (b, 1500, d)."""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="whisper-medium", family="audio",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16,
    d_ff=4096, vocab=51865, encoder_layers=24,
    n_ctx_tokens=1500, mlp_kind="gelu", quant="w8a8",
))
