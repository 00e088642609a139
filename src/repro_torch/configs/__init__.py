"""Configurations of the port: the paper's CNN workloads
(``qappa_workloads``) and the reference's pool of ten language models:
the dense ones (gemma3 with its local:global windows among them), the
mixtures of experts (moonshot, phi3.5-moe), the SSM (mamba2), the hybrid
(zamba2), the vision-language model with cross-attention layers
(llama-3.2-vision) and the encoder-decoder audio model (whisper)."""

ALL_ARCHS = (
    "moonshot-v1-16b-a3b",
    "phi3.5-moe-42b-a6.6b",
    "starcoder2-7b",
    "phi4-mini-3.8b",
    "deepseek-67b",
    "gemma3-4b",
    "mamba2-130m",
    "zamba2-1.2b",
    "llama-3.2-vision-90b",
    "whisper-medium",
)

_MODULES = {
    "moonshot-v1-16b-a3b": "moonshot_v1_16b_a3b",
    "phi3.5-moe-42b-a6.6b": "phi3_5_moe_42b_a6_6b",
    "starcoder2-7b": "starcoder2_7b",
    "phi4-mini-3.8b": "phi4_mini_3_8b",
    "deepseek-67b": "deepseek_67b",
    "gemma3-4b": "gemma3_4b",
    "mamba2-130m": "mamba2_130m",
    "zamba2-1.2b": "zamba2_1_2b",
    "llama-3.2-vision-90b": "llama_3_2_vision_90b",
    "whisper-medium": "whisper_medium",
}


def get_config(name: str):
    """The registered :class:`~repro_torch.configs.base.ArchConfig`."""
    import importlib
    from repro_torch.configs.base import _REGISTRY
    if name not in _MODULES:
        raise KeyError(
            f"unknown arch {name!r}; the port has "
            f"{list(ALL_ARCHS)}")
    if name not in _REGISTRY:
        importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")
    return _REGISTRY[name]
