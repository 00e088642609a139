"""zamba2-1.2b [hybrid] — Mamba2 + shared attn blocks [arXiv:2411.15242]"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="zamba2-1.2b", family="hybrid",
    n_layers=38, d_model=2048, n_heads=32, n_kv_heads=32,
    d_ff=8192, vocab=32000, ssm_state=64, shared_attn_every=6,
    head_dim=64, quant="w8a8", supports_long_context=True,
))
