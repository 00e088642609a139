"""deepseek-67b [dense] — llama-arch [arXiv:2401.02954; hf]"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="deepseek-67b", family="dense",
    n_layers=95, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=22016, vocab=102400, quant="w8a8",
))
