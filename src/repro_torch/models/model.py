"""The quantization-aware LM of the port: the dense family's serving path.

:class:`Model` is the counterpart of ``repro.models.model.Model`` for
dense models without local:global windows (phi4-mini, starcoder2,
deepseek):

* ``init(generator, quantize=...)`` -> params;
* ``quantize_params(params)`` -> params with every projection quantized;
* ``forward(params, tokens, last_only=)`` -> (logits, aux);
* ``init_cache(batch, max_seq, kv_quant=)`` -> KV caches (bf16, or int8
  with per-(position, head) scales);
* ``decode_step(params, caches, tokens, pos)`` -> (logits, caches), at
  one position or one per slot;
* ``prefill(params, tokens, max_seq=)`` -> (logits, caches).

Params are plain dictionaries: ``embed`` (vocab, d) float32,
``final_norm`` (d,), and ``layers``, a list with one dict per layer
(the reference stacks them on a leading axis for ``lax.scan``; here the
layers run in a Python loop).  A projection is a float (d_in, d_out)
tensor or a :class:`~repro_torch.quant.qlinear.QuantizedTensor`.
Other families raise ``NotImplementedError``; the training loss waits
for the training slice.
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.core.device import resolve_device
from repro_torch.kernels.ops import IMPLS
from repro_torch.models import attention as attn
from repro_torch.models.common import (gelu_mlp, normal_init, rms_norm,
                                       swiglu_mlp)
from repro_torch.quant.policy import QuantPolicy, policy_for
from repro_torch.quant.qlinear import qdot, quantize_weight

# the projections that serving stores quantized (the reference's names)
PROJ_NAMES = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down",
              "wq_x", "wk_img", "wv_img", "wo_x", "in_proj", "out_proj")


def _mlp(xn, lp, cfg, policy, impl):
    if cfg.mlp_kind == "swiglu":
        return swiglu_mlp(xn, lp["w_gate"], lp["w_up"], lp["w_down"],
                          policy, False, impl=impl)
    return gelu_mlp(xn, lp["w_up"], lp["w_down"], policy, False, impl=impl)


def _dense_block(x, lp, cfg, policy, impl):
    h, _ = attn.self_attention(rms_norm(x, lp["ln1"]), lp, cfg,
                               policy=policy, impl=impl)
    x = x + h
    return x + _mlp(rms_norm(x, lp["ln2"]), lp, cfg, policy, impl)


class Model(nn.Module):
    """Dense decoder-only LM.  ``impl`` picks the route of the quantized
    matmuls and of attention (:mod:`repro_torch.kernels.ops`): ``"auto"``
    runs the CUDA kernels on the card and their plain versions on the
    CPU."""

    def __init__(self, cfg: ArchConfig, *, device="cuda",
                 impl: str = "auto"):
        super().__init__()
        if cfg.family != "dense" or cfg.global_every:
            what = "windowed dense (local:global)" if cfg.global_every \
                else repr(cfg.family)
            raise NotImplementedError(
                f"{cfg.name}: the {what} family is not ported yet; the "
                f"port's model runs dense models without windows")
        if impl not in IMPLS:
            raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
        self.cfg = cfg
        self.policy: QuantPolicy = policy_for(cfg.quant)
        self.device = resolve_device(device)
        self.impl = impl

    # ------------------------------------------------------------ params
    def _layer(self, generator: torch.Generator) -> dict:
        cfg, d = self.cfg, self.cfg.d_model
        h, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        so = 0.02 / max(1.0, (2 * cfg.n_layers) ** 0.5)
        ones = torch.ones((d,), dtype=torch.float32, device=self.device)
        lp = {"ln1": ones, "ln2": ones.clone(),
              "wq": normal_init(generator, (d, h * hd)),
              "wk": normal_init(generator, (d, kvh * hd)),
              "wv": normal_init(generator, (d, kvh * hd)),
              "wo": normal_init(generator, (h * hd, d), scale=so)}
        if cfg.mlp_kind == "swiglu":
            lp["w_gate"] = normal_init(generator, (d, cfg.d_ff))
        lp["w_up"] = normal_init(generator, (d, cfg.d_ff))
        lp["w_down"] = normal_init(generator, (cfg.d_ff, d), scale=so)
        return lp

    def init(self, generator: torch.Generator, *,
             quantize: bool = False) -> dict:
        """Random params from ``generator`` (on the model's device).  With
        ``quantize``, each layer is quantized as soon as it is drawn, so
        the float32 copy of only one layer is held at a time."""
        if torch.device(generator.device) != self.device:
            raise ValueError(
                f"generator on {generator.device}, model on {self.device}")
        cfg = self.cfg
        params = {"embed": normal_init(generator, (cfg.vocab, cfg.d_model)),
                  "final_norm": torch.ones((cfg.d_model,),
                                           dtype=torch.float32,
                                           device=self.device),
                  "layers": []}
        for _ in range(cfg.n_layers):
            lp = self._layer(generator)
            params["layers"].append(
                self._quantize_layer(lp) if quantize else lp)
        return params

    def _quantize_layer(self, lp: dict) -> dict:
        return {name: quantize_weight(w, self.policy)
                if name in PROJ_NAMES else w for name, w in lp.items()}

    def quantize_params(self, params: dict) -> dict:
        """Serving-time weight quantization per the config's mode: every
        projection becomes a QuantizedTensor (int8 W8A8 or packed
        pow2-int4 W4A8); embeddings and norms stay as they are."""
        if not self.policy.quantized:
            return params
        return dict(params, layers=[self._quantize_layer(lp)
                                    for lp in params["layers"]])

    # ----------------------------------------------------------- forward
    def forward(self, params: dict, tokens: torch.Tensor, *,
                last_only: bool = False):
        """tokens: (b, s) integer -> (logits (b, s, V), aux).  With
        ``last_only`` the logits of the final position only (serving
        prefill).  ``aux`` is 0: the dense family has no auxiliary
        loss."""
        cfg, policy, impl = self.cfg, self.policy, self.impl
        x = params["embed"][tokens].to(policy.compute_dtype)
        for lp in params["layers"]:
            x = _dense_block(x, lp, cfg, policy, impl)
        if last_only:
            x = x[:, -1:]
        x = rms_norm(x, params["final_norm"])
        logits = qdot(x, params["embed"].T, policy, train=False)
        return logits, torch.zeros((), dtype=torch.float32,
                                   device=self.device)

    # ----------------------------------------------------------- serving
    def init_cache(self, batch: int, max_seq: int, dtype=torch.bfloat16,
                   kv_quant: bool = False) -> dict:
        """KV caches ``k``, ``v`` of shape (L, batch, max_seq, kvh, hd);
        with ``kv_quant``, int8 with float32 scales ``k_scale``,
        ``v_scale`` of shape (L, batch, max_seq, kvh) (LightPE-2 / W8A8
        arithmetic on the KV path)."""
        cfg = self.cfg
        shape = (cfg.n_layers, batch, max_seq, cfg.n_kv_heads, cfg.head_dim)
        if kv_quant:
            dtype = torch.int8
        c = {"k": torch.zeros(shape, dtype=dtype, device=self.device),
             "v": torch.zeros(shape, dtype=dtype, device=self.device)}
        if kv_quant:
            for name in ("k_scale", "v_scale"):
                c[name] = torch.zeros(shape[:-1], dtype=torch.float32,
                                      device=self.device)
        return c

    def decode_step(self, params: dict, caches: dict, tokens: torch.Tensor,
                    pos):
        """One serving step.  tokens: (b, 1) integer; pos: the current
        write position (past = [0, pos]), an int or a ``(b,)`` tensor of
        per-slot positions.  Updates ``caches`` in place and returns
        (logits (b, 1, V), caches)."""
        cfg, policy, impl = self.cfg, self.policy, self.impl
        kv_quant = "k_scale" in caches
        x = params["embed"][tokens].to(policy.compute_dtype)
        for l, lp in enumerate(params["layers"]):
            scales = (caches["k_scale"][l], caches["v_scale"][l]) \
                if kv_quant else None
            h = attn.decode_self_attention(
                rms_norm(x, lp["ln1"]), lp, cfg, caches["k"][l],
                caches["v"][l], pos, policy=policy, kv_scales=scales,
                impl=impl)[0]
            x = x + h
            x = x + _mlp(rms_norm(x, lp["ln2"]), lp, cfg, policy, impl)
        x = rms_norm(x, params["final_norm"])
        logits = qdot(x, params["embed"].T, policy, train=False)
        return logits, caches

    def prefill(self, params: dict, tokens: torch.Tensor, *,
                max_seq: int | None = None):
        """Logits of the prompt (``forward``) and decode caches filled
        with it, as the reference builds them: the prompt is replayed
        through ``decode_step`` into caches of the compute dtype."""
        b, s = tokens.shape
        logits, _ = self.forward(params, tokens)
        caches = self.init_cache(b, max_seq or s,
                                 dtype=self.policy.compute_dtype)
        for i in range(s):
            _, caches = self.decode_step(params, caches, tokens[:, i:i + 1],
                                         i)
        return logits, caches
