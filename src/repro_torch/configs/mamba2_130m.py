"""mamba2-130m [ssm] — SSD (state-space duality) [arXiv:2405.21060]"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="mamba2-130m", family="ssm",
    n_layers=24, d_model=768, n_heads=0, n_kv_heads=0,
    d_ff=0, vocab=50280, ssm_state=128, quant="w8a8",
    supports_long_context=True,
))
