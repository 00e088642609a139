"""gemma3-4b [dense] — 5:1 local:global, 128k [hf:google/gemma-3-1b-pt]

Sliding-window (1024) local layers with a global layer every 6th.
long_500k runs: the local majority is sub-quadratic; decode-step cost of
the global layers is linear in cache length (DESIGN.md §8).
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="gemma3-4b", family="dense",
    n_layers=34, d_model=2560, n_heads=8, n_kv_heads=4,
    d_ff=10240, vocab=262144, head_dim=256,
    window=1024, global_every=6, quant="w8a8",
    supports_long_context=True,
))
