"""Architecture configs and input-shape sets of the port.

A copy of ``repro.configs.base`` without its imports of JAX: the config
dataclasses, the registry and :func:`reduced`.  Parameter counts cover
the families the port's model runs: dense, moe, ssm and hybrid.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str            # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                  # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0            # 0 -> d_model // n_heads
    # MoE
    n_experts: int = 0
    top_k: int = 0
    # SSM / hybrid
    ssm_state: int = 0
    ssm_chunk: int = 512
    shared_attn_every: int = 0   # zamba2: shared attn block period
    # gemma3 local:global
    window: int = 0              # sliding window size for local layers
    global_every: int = 0        # every k-th layer is global
    # vlm
    cross_attn_every: int = 0    # every k-th layer is a cross-attn layer
    n_ctx_tokens: int = 0        # image patches / encoder frames (stub)
    # enc-dec
    encoder_layers: int = 0
    mlp_kind: str = "swiglu"     # swiglu | gelu
    rope_theta: float = 10000.0
    quant: str = "bf16"          # ExecMode value (paper PE-type analogue)
    # full-attention archs skip long_500k (sub-quadratic required)
    supports_long_context: bool = False
    tie_embeddings: bool = True

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim",
                               self.d_model // max(1, self.n_heads))

    @property
    def attn_free(self) -> bool:
        return self.family == "ssm"

    def n_params(self) -> int:
        """Total parameter count (embedding + stacked blocks), the
        reference's formula."""
        d, ff, hd = self.d_model, self.d_ff, self.head_dim
        h, kvh, L = self.n_heads, self.n_kv_heads, self.n_layers
        attn = d * h * hd + 2 * d * kvh * hd + h * hd * d + 2 * d
        per_layer = 0
        if self.family in ("dense", "vlm", "audio"):
            per_layer = attn + 3 * d * ff + 2 * d
        elif self.family == "moe":
            per_layer = attn + self.n_experts * 3 * d * ff \
                + d * self.n_experts + 2 * d
        elif self.family in ("ssm", "hybrid"):
            from repro_torch.models import ssm as _ssm
            per_layer = d * _ssm.in_proj_dim(self) \
                + _ssm.D_CONV * _ssm.conv_dim(self) + 2 * d * d + 2 * d
        total = self.vocab * d + L * per_layer
        if self.family == "hybrid" and self.shared_attn_every:
            total += attn + 3 * d * ff + 2 * d          # one shared block
        if self.family == "vlm" and self.cross_attn_every:
            n_cross = self.n_layers // self.cross_attn_every
            total += n_cross * (attn + 3 * d * ff)
        if self.family == "audio" and self.encoder_layers:
            total += self.encoder_layers * (attn + 2 * d * ff + 2 * d)
        return int(total)

    def n_active_params(self) -> int:
        """Active params per token (MoE: top_k of n_experts, and the
        router; no norms, as the reference counts them)."""
        if self.family != "moe":
            return self.n_params()
        d, ff, hd = self.d_model, self.d_ff, self.head_dim
        h, kvh, L = self.n_heads, self.n_kv_heads, self.n_layers
        attn = d * h * hd + 2 * d * kvh * hd + h * hd * d
        return int(self.vocab * d + L * (attn + self.top_k * 3 * d * ff
                                         + d * self.n_experts))


_REGISTRY: dict[str, ArchConfig] = {}


def register(cfg: ArchConfig) -> ArchConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ArchConfig:
    from repro_torch.configs import get_config as _get
    return _get(name)


def reduced(cfg: ArchConfig, **overrides) -> ArchConfig:
    """A tiny same-family config for CPU smoke tests."""
    small = dict(
        n_layers=2 if not cfg.shared_attn_every else 4,
        d_model=64,
        n_heads=4, n_kv_heads=2 if cfg.n_kv_heads < cfg.n_heads else 4,
        d_ff=128, vocab=256, head_dim=16,
    )
    if cfg.family == "moe":
        small.update(n_experts=4, top_k=2)
    if cfg.family in ("ssm", "hybrid"):
        small.update(ssm_state=16, d_model=64, n_heads=2, n_kv_heads=2,
                     head_dim=32)
    if cfg.shared_attn_every:
        small.update(shared_attn_every=2)
    if cfg.global_every:
        small.update(window=8, global_every=2)
    if cfg.cross_attn_every:
        small.update(cross_attn_every=2, n_ctx_tokens=8)
    if cfg.encoder_layers:
        small.update(encoder_layers=2, n_ctx_tokens=8)
    small.update(overrides)
    return dataclasses.replace(cfg, name=cfg.name + "-smoke", **small)
