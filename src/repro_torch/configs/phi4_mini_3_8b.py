"""phi4-mini-3.8b [dense] — RoPE SwiGLU GQA [arXiv:2412.08905; hf]"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="phi4-mini-3.8b", family="dense",
    n_layers=32, d_model=3072, n_heads=24, n_kv_heads=8,
    d_ff=8192, vocab=200064, quant="w8a8",
))
