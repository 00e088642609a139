"""moonshot-v1-16b-a3b [moe] — kimi/moonlight, 64e top-6
[hf:moonshotai/Moonlight-16B-A3B; hf]"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="moonshot-v1-16b-a3b", family="moe",
    n_layers=48, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=1408, vocab=163840, n_experts=64, top_k=6,
    head_dim=128, quant="w8a8",
))
