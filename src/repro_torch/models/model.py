"""The quantization-aware LM of the port: the serving path and the
evaluation loss of all six families of the reference's ten models.

:class:`Model` is the counterpart of ``repro.models.model.Model`` for
the dense family (phi4-mini, starcoder2, deepseek, and gemma3 with its
sliding-window local layers and a global layer every ``global_every``-th),
the MoE family (moonshot, phi3.5-moe: the dense family's attention with a
top-k mixture of experts, ``models/moe.py``, in place of the MLP), the SSM
family (mamba2: a stack of Mamba-2 layers, ``models/ssm.py``), the
hybrid (zamba2: Mamba-2 layers with one shared attention + MLP block
applied after every ``shared_attn_every``-th layer), the vision-language
model (llama-3.2-vision: dense layers with a cross-attention injection
over image embeddings after every ``cross_attn_every``-th) and the
encoder-decoder audio model (whisper: an encoder of dense blocks over
the frames, then decoder layers of self-attention, cross-attention on
the encoder's output and an MLP):

* ``init(generator, quantize=...)`` -> params;
* ``quantize_params(params)`` -> params with every projection quantized;
* ``forward(params, tokens, ctx=, train=, last_only=)`` -> (logits,
  aux), aux the MoE layers' load-balance losses summed in layer order (0
  for the other families); ``ctx`` (b, n_ctx_tokens, d): the vlm's image
  embeddings or the audio model's frames;
* ``loss(params, batch, train=)`` -> the scalar cross-entropy (+ z-loss),
  with ``batch["ctx"]`` where the family takes one;
* ``init_cache(batch, max_seq, kv_quant=)`` -> decode caches: KV (bf16,
  or int8 with per-(position, head) scales, dense and MoE only; gemma3's local
  layers keep ring buffers of ``window`` positions), the SSM
  ``state`` and ``conv`` caches, the hybrid's ``shared_k`` /
  ``shared_v`` (one entry per application of the shared block), and the
  vlm and audio families' context caches ``ctx_k`` / ``ctx_v`` (one entry
  per cross layer), which ``launch.serve.fill_ctx_caches`` fills;
* ``decode_step(params, caches, tokens, pos)`` -> (logits, caches), at
  one position or (dense, MoE) one per slot;
* ``prefill(params, tokens, max_seq=)`` -> (logits, caches); refused for
  the vlm and audio families (ROADMAP C.10).

Params are plain dictionaries: ``embed`` (vocab, d) float32,
``final_norm`` (d,), ``layers``, a list with one dict per layer (the
reference stacks them on a leading axis for ``lax.scan``; here the layers
run in a Python loop), for the hybrid ``shared``, the shared block's
dict, for the vlm and audio families ``cross_layers``, a list of cross
layers (``ln_x``, ``wq_x``, ``wk_img``, ``wv_img``, ``wo_x``), and for the
audio family ``encoder_layers``, a list of dense blocks.  A projection is
a float (d_in, d_out) tensor or a
:class:`~repro_torch.quant.qlinear.QuantizedTensor`.  An MoE layer also
holds ``router`` (d, E) float32 and the stacked experts
``w_experts_gate`` / ``w_experts_in`` (E, d, ff) and ``w_experts_out``
(E, ff, d): float32 as drawn, in the compute dtype once quantized for
serving (the products cast them to it at every use anyway).

``loss(..., train=True)`` under a quantized policy is the reference's QAT
loss: fake-quantized weights and activations with straight-through
gradients (``qlinear.qdot``, ``moe.expert_ffn``).  Under grad every
attention takes the plain route, on the card too (the kernels have no
backward, ``kernels/ops.py``).  The reference remats each layer in
training; that changes memory, not values, and the port keeps every
activation.
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.core.device import resolve_device
from repro_torch.kernels.ops import IMPLS
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.common import (cross_entropy, embed, gelu_mlp,
                                       normal_init, rms_norm, swiglu_mlp)
from repro_torch.obs import trace as obs_trace
from repro_torch.parallel.sharding import placed_like, shard
from repro_torch.quant.calibrate import PROJ_NAMES
from repro_torch.quant.policy import QuantPolicy, policy_for
from repro_torch.quant.qlinear import qdot, quantize_weight

EXPERT_NAMES = ("w_experts_gate", "w_experts_in", "w_experts_out")
FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm", "audio")


def _layer_span(index: int):
    """The ``model.layer`` span of layer ``index``; its attributes are
    built only while tracing is on."""
    if not obs_trace.is_enabled():
        return obs_trace.NOOP
    return obs_trace.span("model.layer", index=index)


def _mlp(xn, lp, cfg, policy, train, impl):
    if cfg.mlp_kind == "swiglu":
        return swiglu_mlp(xn, lp["w_gate"], lp["w_up"], lp["w_down"],
                          policy, train, impl=impl)
    return gelu_mlp(xn, lp["w_up"], lp["w_down"], policy, train, impl=impl)


def _residual(x, h):
    """``x + h`` placed by the ``residual`` rule.  On a mesh ``h`` (a
    split contraction's ``Partial`` sums) is reduced to that placement
    before the add: the collective is the port's choice, not the add's,
    whose choice moves with the torch version."""
    return shard(x + shard(h, "residual"), "residual")


def _dense_block(x, lp, cfg, policy, train, impl, window=None):
    h, _ = attn.self_attention(rms_norm(x, lp["ln1"]), lp, cfg,
                               policy=policy, train=train, window=window,
                               impl=impl)
    x = _residual(x, h)
    return _residual(x, _mlp(rms_norm(x, lp["ln2"]), lp, cfg, policy, train,
                             impl))


def _moe_block(x, lp, cfg, policy, train, impl):
    h, _ = attn.self_attention(rms_norm(x, lp["ln1"]), lp, cfg,
                               policy=policy, train=train, impl=impl)
    x = _residual(x, h)
    m, aux = moe_mod.moe_ffn_ep(rms_norm(x, lp["ln2"]), lp, cfg,
                                policy=policy, train=train)
    return _residual(x, m), aux


def _mamba_layer(x, lp, cfg, policy, train, impl):
    return _residual(x, ssm_mod.mamba2_block(rms_norm(x, lp["ln1"]), lp, cfg,
                                             policy=policy, train=train,
                                             impl=impl))


def _is_global_layer(cfg, l: int) -> bool:
    """Whether layer ``l`` of a windowed dense model attends globally."""
    return l % cfg.global_every == cfg.global_every - 1


def layer_windows(cfg) -> list:
    """Each layer's attention window: ``cfg.window`` on the local layers
    of a windowed dense model, None (full causal) on its global layers and
    on every layer of the others.  The reference passes ``GLOBAL_WINDOW =
    2^30`` for full; its mask ``ki > qi - 2^30`` keeps every key, as None
    does."""
    if not cfg.global_every:
        return [None] * cfg.n_layers
    return [None if _is_global_layer(cfg, l) else cfg.window
            for l in range(cfg.n_layers)]


def _is_shared_layer(cfg, l: int) -> bool:
    """Whether the hybrid's shared block runs after layer ``l``."""
    every = cfg.shared_attn_every
    return bool(every) and l % every == every - 1


class Model(nn.Module):
    """LM of the dense, moe, ssm, hybrid, vlm or audio family.  ``impl``
    picks the route of the quantized matmuls and of attention
    (:mod:`repro_torch.kernels.ops`): ``"auto"`` runs the CUDA kernels on
    the card and their plain versions on the CPU."""

    def __init__(self, cfg: ArchConfig, *, device="cuda",
                 impl: str = "auto"):
        super().__init__()
        if cfg.family not in FAMILIES:
            raise NotImplementedError(
                f"{cfg.name}: no model family {cfg.family!r}; the port's "
                f"model runs the reference's {FAMILIES}")
        if impl not in IMPLS:
            raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
        if cfg.family == "vlm" and cfg.n_layers % cfg.cross_attn_every:
            raise ValueError(
                f"{cfg.name}: {cfg.n_layers} layers are not whole groups of "
                f"cross_attn_every = {cfg.cross_attn_every}")
        self.cfg = cfg
        self.policy: QuantPolicy = policy_for(cfg.quant)
        self.device = resolve_device(device)
        self.impl = impl

    # ------------------------------------------------------------ params
    def _ones(self) -> torch.Tensor:
        return torch.ones((self.cfg.d_model,), dtype=torch.float32,
                          device=self.device)

    def _attn(self, generator: torch.Generator,
              scale_attn_out: float) -> dict:
        """ln1, ln2 and the attention projections (``wo`` drawn at
        ``scale_attn_out``)."""
        cfg, d = self.cfg, self.cfg.d_model
        h, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        return {"ln1": self._ones(), "ln2": self._ones(),
                "wq": normal_init(generator, (d, h * hd)),
                "wk": normal_init(generator, (d, kvh * hd)),
                "wv": normal_init(generator, (d, kvh * hd)),
                "wo": normal_init(generator, (h * hd, d),
                                  scale=scale_attn_out)}

    def _attn_mlp(self, generator: torch.Generator,
                  scale_attn_out: float) -> dict:
        """:meth:`_attn` and the MLP of a dense or shared block."""
        cfg, d = self.cfg, self.cfg.d_model
        so = 0.02 / max(1.0, (2 * cfg.n_layers) ** 0.5)
        lp = self._attn(generator, scale_attn_out)
        if cfg.mlp_kind == "swiglu":
            lp["w_gate"] = normal_init(generator, (d, cfg.d_ff))
        lp["w_up"] = normal_init(generator, (d, cfg.d_ff))
        lp["w_down"] = normal_init(generator, (cfg.d_ff, d), scale=so)
        return lp

    def _mamba(self, generator: torch.Generator) -> dict:
        """The reference's ``_mamba_params`` and ``ln1``: ``conv_w`` at
        scale 0.2, ``dt_bias`` 0, ``a_log`` 0 (A = -1), ``d_skip`` 1."""
        cfg, d = self.cfg, self.cfg.d_model
        d_inner, h, _, _ = ssm_mod.dims(cfg)
        so = 0.02 / max(1.0, (2 * cfg.n_layers) ** 0.5)

        def vec(value):
            return torch.full((h,), value, dtype=torch.float32,
                              device=self.device)
        return {"ln1": self._ones(),
                "in_proj": normal_init(generator,
                                       (d, ssm_mod.in_proj_dim(cfg))),
                "conv_w": normal_init(generator, (ssm_mod.D_CONV,
                                                  ssm_mod.conv_dim(cfg)),
                                      scale=0.2),
                "dt_bias": vec(0.0), "a_log": vec(0.0), "d_skip": vec(1.0),
                "out_proj": normal_init(generator, (d_inner, d), scale=so)}

    def _moe(self, generator: torch.Generator, so: float) -> dict:
        """:meth:`_attn` and the reference's ``_moe_params``: ``router``
        and the gate / in experts at scale 0.02, the out experts at
        ``so``."""
        cfg, d = self.cfg, self.cfg.d_model
        E, ff = cfg.n_experts, cfg.d_ff
        lp = self._attn(generator, so)
        lp.update(router=normal_init(generator, (d, E)),
                  w_experts_gate=normal_init(generator, (E, d, ff)),
                  w_experts_in=normal_init(generator, (E, d, ff)),
                  w_experts_out=normal_init(generator, (E, ff, d),
                                            scale=so))
        return lp

    def _cross(self, generator: torch.Generator) -> dict:
        """The reference's ``_cross_params`` and ``ln_x``: ``wo_x`` at the
        layers' output scale."""
        cfg, d = self.cfg, self.cfg.d_model
        h, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        so = 0.02 / max(1.0, (2 * cfg.n_layers) ** 0.5)
        return {"ln_x": self._ones(),
                "wq_x": normal_init(generator, (d, h * hd)),
                "wk_img": normal_init(generator, (d, kvh * hd)),
                "wv_img": normal_init(generator, (d, kvh * hd)),
                "wo_x": normal_init(generator, (h * hd, d), scale=so)}

    def _layer(self, generator: torch.Generator) -> dict:
        so = 0.02 / max(1.0, (2 * self.cfg.n_layers) ** 0.5)
        if self.cfg.family in ("dense", "vlm", "audio"):
            return self._attn_mlp(generator, so)
        if self.cfg.family == "moe":
            return self._moe(generator, so)
        return self._mamba(generator)

    def init(self, generator: torch.Generator, *,
             quantize: bool = False) -> dict:
        """Random params from ``generator`` (on the model's device).  With
        ``quantize``, each layer is quantized (its experts cast to the
        compute dtype) as soon as it is drawn, so the float32 copy of only
        one layer is held at a time."""
        if torch.device(generator.device) != self.device:
            raise ValueError(
                f"generator on {generator.device}, model on {self.device}")
        cfg = self.cfg
        params = {"embed": normal_init(generator, (cfg.vocab, cfg.d_model)),
                  "final_norm": self._ones(), "layers": []}

        def keep(lp):
            return self._quantize_layer(lp) if quantize else lp
        for _ in range(cfg.n_layers):
            params["layers"].append(keep(self._layer(generator)))
        if cfg.family == "hybrid":      # the shared attention + MLP block
            params["shared"] = keep(self._attn_mlp(generator, 0.01))
        if cfg.family == "audio":       # whisper's encoder
            params["encoder_layers"] = [
                keep(self._attn_mlp(generator, 0.01))
                for _ in range(cfg.encoder_layers)]
        if cfg.family in ("vlm", "audio"):
            params["cross_layers"] = [keep(self._cross(generator))
                                      for _ in range(self._n_cross())]
        return params

    def _quantize_layer(self, lp: dict) -> dict:
        def convert(name, w):
            if name in PROJ_NAMES:
                return quantize_weight(w, self.policy)
            if name in EXPERT_NAMES:
                return w.to(self.policy.compute_dtype)
            return w
        return {name: convert(name, w) for name, w in lp.items()}

    def quantize_params(self, params: dict) -> dict:
        """Serving-time weight quantization per the config's mode: every
        projection (the hybrid's shared block's, the cross and encoder
        layers' too) becomes a
        QuantizedTensor (int8 W8A8 or packed pow2-int4 W4A8); the stacked
        experts are stored in the compute dtype (the reference keeps them
        float32 and casts them to it at every use: the same products);
        embeddings, norms, the router, ``conv_w`` and the SSM vectors stay
        as they are."""
        if not self.policy.quantized:
            return params
        out = dict(params)
        for key in ("layers", "cross_layers", "encoder_layers"):
            if key in params:
                out[key] = [self._quantize_layer(lp) for lp in params[key]]
        if "shared" in params:
            out["shared"] = self._quantize_layer(params["shared"])
        return out

    # ----------------------------------------------------------- forward
    def forward(self, params: dict, tokens: torch.Tensor, *,
                ctx: torch.Tensor | None = None, train: bool = False,
                last_only: bool = False):
        """tokens: (b, s) integer -> (logits (b, s, V), aux).  ``ctx``
        (b, n_ctx_tokens, d): the vlm's image embeddings or the audio
        model's frames (required there, unused elsewhere).  With
        ``last_only`` the logits of the final position only (serving
        prefill).  ``train`` goes to every ``qdot`` (QAT under a quantized
        policy on float weights).  ``aux``: the MoE
        layers' load-balance losses summed in float32 in layer order (the
        reference's scan carry), 0 for the other families.

        Spans, while tracing is on: ``model.forward`` (``batch``,
        ``tokens``: all the batch's positions), the root of the call's
        spans, and in it ``model.embed``, ``model.layer`` (``index``) for
        each layer of every stack and ``model.logits`` (the final norm and
        the logits' product)."""
        if not obs_trace.is_enabled():
            return self._forward(params, tokens, ctx, train, last_only)
        with obs_trace.span("model.forward", batch=int(tokens.shape[0]),
                            tokens=int(tokens.numel())):
            return self._forward(params, tokens, ctx, train, last_only)

    def _forward(self, params, tokens, ctx, train, last_only):
        cfg, policy, impl = self.cfg, self.policy, self.impl
        with obs_trace.span("model.embed"):
            x = shard(embed(params["embed"], tokens).to(
                policy.compute_dtype), "residual")
        aux = torch.zeros((), dtype=torch.float32, device=self.device)
        if cfg.family in ("vlm", "audio"):
            if ctx is None:
                raise ValueError(f"{cfg.name}: the {cfg.family!r} family's "
                                 f"forward needs ctx (b, n_ctx, d)")
            x = (self._vlm_forward if cfg.family == "vlm"
                 else self._audio_forward)(params, x, ctx, train)
        else:
            x, aux = self._stack_forward(params, x, aux, train)
        with obs_trace.span("model.logits"):
            if last_only:
                x = x[:, -1:]
            x = rms_norm(x, params["final_norm"])
            logits = qdot(x, params["embed"].T, policy, train=train)
        return (shard(logits, "logits") if not last_only else logits), aux

    def _stack_forward(self, params, x, aux, train):
        """The dense, MoE, SSM and hybrid layer stacks; returns (x, aux)."""
        cfg, policy, impl = self.cfg, self.policy, self.impl
        windows = layer_windows(cfg)
        for l, lp in enumerate(params["layers"]):
            with _layer_span(l):
                if cfg.family == "dense":
                    x = _dense_block(x, lp, cfg, policy, train, impl,
                                     window=windows[l])
                    continue
                if cfg.family == "moe":
                    x, a = _moe_block(x, lp, cfg, policy, train, impl)
                    aux = aux + a
                    continue
                x = _mamba_layer(x, lp, cfg, policy, train, impl)
                if cfg.family == "hybrid" and _is_shared_layer(cfg, l):
                    x = _dense_block(x, params["shared"], cfg, policy,
                                     train, impl)
        return x, aux

    def _cross_block(self, x, cp, ck, cv, train):
        """The residual cross-attention injection of one cross layer."""
        return _residual(x, attn.cross_attention(
            rms_norm(x, cp["ln_x"]), ck, cv, cp, self.cfg,
            policy=self.policy, train=train, impl=self.impl))

    def _vlm_forward(self, params, x, ctx, train):
        """Groups of ``cross_attn_every`` dense blocks, each group followed
        by its cross layer over ``ctx``, which goes to ``context_kv`` as it
        is (uncast, as the reference's forward passes it)."""
        cfg, policy, impl = self.cfg, self.policy, self.impl
        k = cfg.cross_attn_every
        for g, cp in enumerate(params["cross_layers"]):
            for l, lp in enumerate(params["layers"][g * k:(g + 1) * k],
                                   start=g * k):
                with _layer_span(l):
                    x = _dense_block(x, lp, cfg, policy, train, impl)
            ck, cv = attn.context_kv(ctx, cp, cfg, policy=policy,
                                     train=train, impl=impl)
            x = self._cross_block(x, cp, ck, cv, train)
        return x

    def _audio_forward(self, params, x, frames, train):
        """The encoder over ``frames``, then per decoder layer
        self-attention, cross-attention on the encoder's output and the
        MLP."""
        cfg, policy, impl = self.cfg, self.policy, self.impl
        enc = self._encode(params, frames, train)
        for l, (lp, cp) in enumerate(zip(params["layers"],
                                         params["cross_layers"])):
            with _layer_span(l):
                h, _ = attn.self_attention(rms_norm(x, lp["ln1"]), lp, cfg,
                                           policy=policy, train=train,
                                           impl=impl)
                x = _residual(x, h)
                ck, cv = attn.context_kv(enc, cp, cfg, policy=policy,
                                         train=train, impl=impl)
                x = self._cross_block(x, cp, ck, cv, train)
                x = _residual(x, _mlp(rms_norm(x, lp["ln2"]), lp, cfg,
                                      policy, train, impl))
        return x

    def _encode(self, params: dict, frames: torch.Tensor,
                train: bool = False) -> torch.Tensor:
        """whisper's encoder: ``frames`` (b, n_ctx, d) cast to the compute
        dtype through the dense blocks of ``encoder_layers``.  Their
        attention is causal, as the reference's ``self_attention`` always
        is, though its comments call the encoder bidirectional (ROADMAP
        C.11)."""
        x = shard(frames.to(self.policy.compute_dtype), "residual")
        for l, lp in enumerate(params["encoder_layers"]):
            with _layer_span(l):
                x = _dense_block(x, lp, self.cfg, self.policy, train,
                                 self.impl)
        return x

    def loss(self, params: dict, batch: dict, *,
             train: bool = True) -> torch.Tensor:
        """Mean token cross-entropy (+ z-loss) of ``batch["tokens"]``
        against ``batch["labels"]``, plus 0.01 x the auxiliary loss;
        ``batch["ctx"]``, where present, goes to ``forward``."""
        logits, aux = self.forward(params, batch["tokens"],
                                   ctx=batch.get("ctx"), train=train)
        return cross_entropy(logits, batch["labels"]) + 0.01 * aux

    # ----------------------------------------------------------- serving
    def _n_cross(self) -> int:
        """Cross layers: one a group of ``cross_attn_every`` layers (vlm),
        one a layer (audio), none elsewhere."""
        cfg = self.cfg
        if cfg.family == "vlm":
            return cfg.n_layers // cfg.cross_attn_every
        return cfg.n_layers if cfg.family == "audio" else 0

    def _n_shared_apps(self) -> int:
        return sum(_is_shared_layer(self.cfg, l)
                   for l in range(self.cfg.n_layers))

    def init_cache(self, batch: int, max_seq: int, dtype=torch.bfloat16,
                   kv_quant: bool = False) -> dict:
        """Decode caches.  Dense and MoE: KV caches ``k``, ``v`` of shape (L,
        batch, max_seq, kvh, hd); with ``kv_quant``, int8 with float32
        scales ``k_scale``, ``v_scale`` of shape (L, batch, max_seq, kvh)
        (LightPE-2 / W8A8 arithmetic on the KV path).  Windowed dense
        (gemma3): ``k``, ``v`` hold the global layers only, and the local
        layers keep ring buffers ``k_local``, ``v_local`` of (n_local,
        batch, min(window, max_seq), kvh, hd), with ``k_local_scale``,
        ``v_local_scale`` under ``kv_quant``.  SSM and hybrid:
        ``state`` (L, batch, h, 64, n) float32 and ``conv`` (L, batch, 3,
        conv_dim); the hybrid also ``shared_k`` / ``shared_v`` (one entry
        per application of the shared block, batch, max_seq, kvh, hd).
        vlm and audio: ``k``, ``v`` as dense, and the context caches
        ``ctx_k``, ``ctx_v`` (one entry per cross layer, batch,
        n_ctx_tokens, kvh, hd), zero until filled.  The reference has no
        int8 KV for the families other than dense and moe: ``kv_quant``
        raises for them."""
        cfg = self.cfg
        L, kvh, hd = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim
        if kv_quant and cfg.family not in ("dense", "moe"):
            raise NotImplementedError(
                f"int8 KV is implemented for dense and moe decode (the "
                f"reference's), not for the {cfg.family!r} family")

        def zeros(shape, dt):
            return torch.zeros(shape, dtype=dt, device=self.device)
        c = {}
        if cfg.family in ("vlm", "audio"):
            for key, n, seq in (("", L, max_seq),
                                ("ctx_", self._n_cross(), cfg.n_ctx_tokens)):
                shape = (n, batch, seq, kvh, hd)
                c[key + "k"], c[key + "v"] = zeros(shape, dtype), \
                    zeros(shape, dtype)
            return c
        if cfg.family in ("dense", "moe"):
            if kv_quant:
                dtype = torch.int8
            groups = {"": (L, max_seq)}
            if cfg.global_every:
                n_glob = cfg.n_layers // cfg.global_every
                groups = {"": (n_glob, max_seq),
                          "_local": (L - n_glob, min(cfg.window, max_seq))}
            for pre, (n, seq) in groups.items():
                shape = (n, batch, seq, kvh, hd)
                c["k" + pre], c["v" + pre] = zeros(shape, dtype), \
                    zeros(shape, dtype)
                if kv_quant:
                    c[f"k{pre}_scale"] = zeros(shape[:-1], torch.float32)
                    c[f"v{pre}_scale"] = zeros(shape[:-1], torch.float32)
            return c
        _, h, _, n = ssm_mod.dims(cfg)
        c["state"] = zeros((L, batch, h, ssm_mod.P_HEADDIM, n),
                           torch.float32)
        c["conv"] = zeros((L, batch, ssm_mod.D_CONV - 1,
                           ssm_mod.conv_dim(cfg)), dtype)
        if cfg.family == "hybrid" and cfg.shared_attn_every:
            shape = (self._n_shared_apps(), batch, max_seq, kvh, hd)
            c["shared_k"], c["shared_v"] = zeros(shape, dtype), \
                zeros(shape, dtype)
        return c

    def decode_step(self, params: dict, caches: dict, tokens: torch.Tensor,
                    pos):
        """One serving step.  tokens: (b, 1) integer; pos: the current
        write position (past = [0, pos]), an int or a ``(b,)`` tensor of
        per-slot positions (dense and MoE: the SSM state has no positions).
        Updates ``caches`` in place and returns (logits (b, 1, V),
        caches)."""
        cfg = self.cfg
        x = shard(embed(params["embed"], tokens).to(
            self.policy.compute_dtype), "residual")
        if cfg.family in ("dense", "moe"):
            x = self._dense_decode(params, caches, x, pos)
        elif cfg.family in ("vlm", "audio"):
            x = self._cross_decode(params, caches, x, pos)
        else:
            x = self._ssm_decode(params, caches, x, pos)
        x = rms_norm(x, params["final_norm"])
        logits = qdot(x, params["embed"].T, self.policy, train=False)
        return logits, caches

    def _dense_decode(self, params, caches, x, pos):
        """The dense and MoE layers, the reference's scan body and its
        ``_windowed_decode`` in one loop: a windowed model's (gemma3)
        global layers decode on ``k`` / ``v`` and its local layers on
        their ring buffers ``k_local`` / ``v_local`` (``static_window`` =
        the ring's length).  An MoE layer runs ``moe_ffn_ep`` (without a
        mesh ``moe_ffn``) over the b tokens of the step in place of the
        MLP."""
        cfg, policy, impl = self.cfg, self.policy, self.impl
        kv_quant = "k_scale" in caches
        ring = caches["k_local"].shape[2] if "k_local" in caches else None
        index = {"": 0, "_local": 0}
        for lp, window in zip(params["layers"], layer_windows(cfg)):
            pre = "" if window is None else "_local"
            i = index[pre]
            index[pre] += 1
            scales = (caches[f"k{pre}_scale"][i], caches[f"v{pre}_scale"][i]) \
                if kv_quant else None
            h = attn.decode_self_attention(
                rms_norm(x, lp["ln1"]), lp, cfg, caches["k" + pre][i],
                caches["v" + pre][i], pos, policy=policy,
                static_window=ring if pre else None, kv_scales=scales,
                impl=impl)[0]
            x = _residual(x, h)
            xn = rms_norm(x, lp["ln2"])
            if cfg.family == "moe":
                x = _residual(x, moe_mod.moe_ffn_ep(
                    xn, lp, cfg, policy=policy, train=False)[0])
            else:
                x = _residual(x, _mlp(xn, lp, cfg, policy, False, impl))
        return x

    def _cross_decode(self, params, caches, x, pos):
        """The vlm's and audio model's decoder layers on the filled context
        caches: the vlm's dense layers with the cross injection after every
        ``cross_attn_every``-th (the reference's ``_vlm_decode``), the
        audio model's self-attention, cross-attention and MLP a layer
        (``_audio_decode``)."""
        cfg, policy, impl = self.cfg, self.policy, self.impl
        audio = cfg.family == "audio"
        every = 1 if audio else cfg.cross_attn_every
        for l, lp in enumerate(params["layers"]):
            x = _residual(x, attn.decode_self_attention(
                rms_norm(x, lp["ln1"]), lp, cfg, caches["k"][l],
                caches["v"][l], pos, policy=policy, impl=impl)[0])
            g = l // every
            if audio:
                x = self._cross_block(x, params["cross_layers"][g],
                                      caches["ctx_k"][g], caches["ctx_v"][g],
                                      False)
            x = _residual(x, _mlp(rms_norm(x, lp["ln2"]), lp, cfg, policy,
                                  False, impl))
            if not audio and l % every == every - 1:
                x = self._cross_block(x, params["cross_layers"][g],
                                      caches["ctx_k"][g], caches["ctx_v"][g],
                                      False)
        return x

    def _ssm_decode(self, params, caches, x, pos):
        """The SSM family's layer scan and the hybrid's unrolled layers
        with the shared block's decode attention after every
        ``shared_attn_every``-th."""
        cfg, policy, impl = self.cfg, self.policy, self.impl
        app = 0
        for l, lp in enumerate(params["layers"]):
            y, st, cv = ssm_mod.mamba2_decode(
                rms_norm(x, lp["ln1"]), lp, cfg, caches["state"][l],
                caches["conv"][l], policy=policy, impl=impl)
            x = _residual(x, y)
            if cfg.family == "ssm" and cv.dtype != caches["conv"].dtype:
                # the reference's layer scan stacks the promoted window:
                # a float32 step on a bf16 cache leaves it float32 (its
                # hybrid writes into the cache's dtype instead)
                caches["conv"] = caches["conv"].to(cv.dtype)
            caches["state"][l] = placed_like(st, caches["state"][l])
            caches["conv"][l] = placed_like(cv, caches["conv"][l])
            if cfg.family == "hybrid" and _is_shared_layer(cfg, l):
                sp = params["shared"]
                h = attn.decode_self_attention(
                    rms_norm(x, sp["ln1"]), sp, cfg, caches["shared_k"][app],
                    caches["shared_v"][app], pos, policy=policy,
                    impl=impl)[0]
                x = _residual(x, h)
                x = _residual(x, _mlp(rms_norm(x, sp["ln2"]), sp, cfg, policy,
                                      False, impl))
                app += 1
        return x

    def prefill(self, params: dict, tokens: torch.Tensor, *,
                max_seq: int | None = None):
        """Logits of the prompt (``forward``) and decode caches filled
        with it, as the reference builds them: the prompt is replayed
        through ``decode_step`` into caches of the compute dtype.

        Refused for the vlm and audio families (ROADMAP C.10): the
        reference's ``prefill`` never fills the context caches, so its
        decode after it attends to an all-zero context.  Serve them
        through ``launch.serve.generate``, which fills them first."""
        if self.cfg.family in ("vlm", "audio"):
            raise NotImplementedError(
                f"{self.cfg.name}: prefill of the {self.cfg.family!r} "
                f"family is refused (ROADMAP C.10): the reference's prefill "
                f"leaves ctx_k / ctx_v zero, so decoding after it would "
                f"attend to no context; use launch.serve.generate, which "
                f"fills them with fill_ctx_caches")
        b, s = tokens.shape
        logits, _ = self.forward(params, tokens)
        caches = self.init_cache(b, max_seq or s,
                                 dtype=self.policy.compute_dtype)
        for i in range(s):
            _, caches = self.decode_step(params, caches, tokens[:, i:i + 1],
                                         i)
        return logits, caches
