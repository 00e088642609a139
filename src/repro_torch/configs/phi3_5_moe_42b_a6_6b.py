"""phi3.5-moe-42b-a6.6b [moe] — 16 experts top-2
[hf:microsoft/Phi-3.5-MoE-instruct; hf]"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="phi3.5-moe-42b-a6.6b", family="moe",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=6400, vocab=32064, n_experts=16, top_k=2, quant="w8a8",
))
