"""Batched serving driver: prefill + greedy decode with (optionally
quantized) weights, the LightPE deployment path.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3-4b \
      --batch 4 --prompt-len 16 --gen 16 --quant [--full] [--device cpu]

An MoE model at full width needs ``--quant``: unquantized, its stacked
experts stay float32 (moonshot-v1-16b-a3b: 106.3 GB, past an 80 GB card);
quantized, they are stored in bf16 (53.2 GB).  llama-3.2-vision-90b needs
it too: in int8 (W8A8, its config's mode) its 100 layers are 92.8 GB,
past an 80 GB card, while in W4A8-pow2 they are 48.5 GB and serve whole
on one H100 80GB (51.4 GB at peak): build :class:`Model` with the
config's ``quant`` set to ``"w4a8_pow2"`` and call :func:`fill_ctx_caches`
and :func:`generate`.  Any model whose float32 params pass the device's
memory needs ``--quant`` as well (deepseek-67b: 266.4 GB by the
reference's count; 69.1 GB in W8A8).

The vlm and audio families take a context: ``serve`` draws image
embeddings or audio frames ``(batch, n_ctx_tokens, d) * 0.02`` from
``seed + 2``, and :func:`fill_ctx_caches` projects them once into the
context caches (whisper's through its encoder first) before the prompt
is replayed.
"""

from __future__ import annotations

import argparse
import os
import time

import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import reduced
from repro_torch.core.device import resolve_device
from repro_torch.models.attention import context_kv
from repro_torch.models.model import Model


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def fill_ctx_caches(model: Model, params: dict, caches: dict,
                    ctx: torch.Tensor) -> dict:
    """The reference's ``_fill_ctx_caches``: the context ``ctx`` (b,
    n_ctx_tokens, d) projected once to each cross layer's keys and values,
    written into ``caches["ctx_k"]`` / ``["ctx_v"]`` in their dtype (in
    place; the caches are returned).  The audio model's frames go through
    its encoder first; the vlm's image embeddings are cast to the compute
    dtype."""
    cfg, policy = model.cfg, model.policy
    if cfg.family == "audio":
        enc = model._encode(params, ctx)
    else:
        enc = ctx.to(policy.compute_dtype)
    for g, cp in enumerate(params["cross_layers"]):
        k, v = context_kv(enc, cp, cfg, policy=policy, impl=model.impl)
        caches["ctx_k"][g] = k.to(caches["ctx_k"].dtype)
        caches["ctx_v"][g] = v.to(caches["ctx_v"].dtype)
    return caches


def generate(model: Model, params: dict, prompts: torch.Tensor, *,
             gen: int, ctx: torch.Tensor | None = None,
             caches: dict | None = None) -> dict:
    """The serving loop on a built model: prefill by replaying the prompt
    through ``decode_step`` (cache build), then ``gen`` greedy steps.
    ``caches``: caches of ``prompt_len + gen`` positions to start from
    (the vlm and audio families' with their context caches filled);
    otherwise they are made here, and for those families filled from
    ``ctx`` by :func:`fill_ctx_caches` within ``prefill_s``, as the
    reference's ``serve`` times it.  Times are host wall times that end
    in a device synchronize."""
    batch, prompt_len = prompts.shape
    dev = model.device
    needs_ctx = model.cfg.family in ("vlm", "audio")
    if needs_ctx and caches is None and ctx is None:
        raise ValueError(f"{model.cfg.name}: the {model.cfg.family!r} "
                         f"family needs ctx or filled caches")
    _sync(dev)
    t0 = time.perf_counter()
    if caches is None:
        caches = model.init_cache(batch, prompt_len + gen)
        if needs_ctx:
            caches = fill_ctx_caches(model, params, caches, ctx)
    logits = None
    for i in range(prompt_len):
        logits, caches = model.decode_step(params, caches,
                                           prompts[:, i:i + 1], i)
    _sync(dev)
    prefill_s = time.perf_counter() - t0

    out = []
    tok = torch.argmax(logits[:, -1:], dim=-1)
    t0 = time.perf_counter()
    for i in range(gen):
        out.append(tok)
        logits, caches = model.decode_step(params, caches, tok,
                                           prompt_len + i)
        tok = torch.argmax(logits[:, -1:], dim=-1)
    _sync(dev)
    decode_s = time.perf_counter() - t0
    return {
        "tokens": torch.cat(out, dim=1).to(torch.int32),
        "prefill_s": prefill_s,
        "decode_s": decode_s,
        "tok_per_s": batch * gen / max(decode_s, 1e-9),
    }


def expert_bytes(cfg, quantize: bool) -> int:
    """Bytes of an MoE model's stacked experts: float32 as drawn, 2 a
    weight once quantized (bf16, the compute dtype of its mode)."""
    n = cfg.n_layers * 3 * cfg.n_experts * cfg.d_model * cfg.d_ff
    return n * (2 if quantize else 4)


def device_memory_bytes(dev: torch.device) -> int:
    """Memory of ``dev``: the card's total, or the host's physical
    memory."""
    if dev.type == "cuda":
        return torch.cuda.get_device_properties(dev).total_memory
    return os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")


def serve(arch: str, *, batch: int = 4, prompt_len: int = 16,
          gen: int = 16, quantize: bool = False, smoke: bool = True,
          seed: int = 0, greedy: bool = True, device="cuda") -> dict:
    """Serve ``batch`` random prompts of ``arch`` (reduced to smoke size
    unless ``smoke=False``) with random weights from ``seed``, prompts
    from ``seed + 1`` and, for the vlm and audio families, the context
    from ``seed + 2``.  Returns ``tokens`` (batch, gen) int32,
    ``prefill_s``, ``decode_s`` and ``tok_per_s``.  An MoE model at full
    width without ``quantize`` is refused: its float32 experts would be
    drawn whole (see :func:`expert_bytes`); so is the vlm, whose
    projections would stay float32, and any model whose float32 params
    (``4 * cfg.n_params()`` bytes) pass the device's memory
    (:func:`device_memory_bytes`), before anything is drawn."""
    if not greedy:
        raise NotImplementedError(
            "sampling is not implemented: decoding is greedy, as in the "
            "reference")
    dev = resolve_device(device)
    cfg = get_config(arch)
    if smoke:
        cfg = reduced(cfg)
    elif cfg.family == "moe" and not quantize:
        raise ValueError(
            f"{arch} at full width without quantize keeps its experts "
            f"float32: {expert_bytes(cfg, False) / 1e9:.1f} GB "
            f"({expert_bytes(cfg, True) / 1e9:.1f} GB once quantized, "
            f"stored in the compute dtype); pass quantize=True (--quant)")
    elif cfg.family == "vlm" and not quantize:
        raise ValueError(
            f"{arch} at full width without quantize keeps every projection "
            f"float32, four times the bytes of its int8 ones; pass "
            f"quantize=True (--quant)")
    elif not quantize and 4 * cfg.n_params() > device_memory_bytes(dev):
        raise ValueError(
            f"{arch} at full width without quantize draws "
            f"{4 * cfg.n_params() / 1e9:.1f} GB of float32 params, past the "
            f"{device_memory_bytes(dev) / 1e9:.1f} GB of {dev}; pass "
            f"quantize=True (--quant)")
    model = Model(cfg, device=dev)
    params = model.init(torch.Generator(dev).manual_seed(seed),
                        quantize=quantize)
    prompts = torch.randint(0, cfg.vocab, (batch, prompt_len),
                            generator=torch.Generator(dev).manual_seed(
                                seed + 1), device=dev)
    ctx = None
    if cfg.family in ("vlm", "audio"):
        ctx = torch.randn((batch, cfg.n_ctx_tokens, cfg.d_model),
                          generator=torch.Generator(dev).manual_seed(
                              seed + 2), device=dev) * 0.02
    return generate(model, params, prompts, gen=gen, ctx=ctx)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma3-4b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--quant", action="store_true",
                    help="quantize the projections for serving (and store "
                         "an MoE model's experts in bf16)")
    ap.add_argument("--full", action="store_true",
                    help="the config's full width (default: reduced); the "
                         "MoE models need --quant there (moonshot-v1-16b-a3b"
                         "'s float32 experts are 106.3 GB), and so do "
                         "llama-3.2-vision-90b (92.8 GB in W8A8, past an 80 "
                         "GB card; whole in W4A8-pow2, 48.5 GB, through "
                         "generate()) and any model whose float32 params "
                         "pass the device's memory (deepseek-67b); "
                         "whisper-medium fits either way")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    res = serve(args.arch, batch=args.batch, prompt_len=args.prompt_len,
                gen=args.gen, quantize=args.quant, smoke=not args.full,
                device=args.device)
    print(f"generated shape={tuple(res['tokens'].shape)} "
          f"prefill={res['prefill_s']:.2f}s decode={res['decode_s']:.2f}s "
          f"({res['tok_per_s']:.1f} tok/s)")


if __name__ == "__main__":
    main()
