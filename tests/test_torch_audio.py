"""The port's audio family (whisper-medium: an encoder of dense blocks over
the frames, then decoder layers of self-attention, cross-attention on the
encoder's output and a gelu MLP) against the JAX reference: the encoder
(``Model._encode``) and its causal attention (ROADMAP C.11), the reduced
model's forward with frames and its loss, ``fill_ctx_caches``,
teacher-forced decode on filled and carried context caches, the init
layout, ``n_params``, ``serve`` on the CPU, and ROADMAP C.10.  The shared
checks and their bounds are in ``tests/test_torch_vlm.py``.

Bounds, with the maxima measured on the CPU (torch 2.13, jax 0.9.0;
``pytest -s`` prints them): the encoder's output 1e-5 under ``fp32``
(measured 2.0e-8 at |x| ~ 0.1), 2e-2 under bf16 and W8A8 (measured
4.9e-4 and 1.2e-3); the rest as in ``tests/test_torch_vlm.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as r_get_config
from repro_torch.configs import get_config
from test_torch_serve import _models
from test_torch_vlm import (MODES, _close, _ctx, _tol, check_cross_attention,
                            check_fill_ctx_caches, check_forward_and_loss,
                            check_init_layout, check_n_params,
                            check_port_refusals, check_serve_cpu,
                            check_teacher_forced_decode, pin_reference_c10)

AUDIO = "whisper-medium"


@pytest.mark.parametrize("mode", ["fp32", "bf16", "w8a8"])
@pytest.mark.parametrize("sq", [1, 8])
def test_cross_attention_at_rep_8_matches_reference(mode, sq):
    """The decoder's cross-attention over the encoder's keys and values
    with 8 q heads a kv head, at one token and at eight, against the
    reference's ``cross_attention`` (whisper-medium itself has rep 1)."""
    check_cross_attention(AUDIO, mode, sq, n_heads=8, n_kv_heads=1)


@pytest.mark.parametrize("mode,quantize", MODES)
def test_encode_matches_reference(mode, quantize):
    """The encoder over (2, n_ctx, d) frames: its output against the
    reference's ``_encode``, in the compute dtype."""
    rmodel, rparams, tmodel, tparams = _models(AUDIO, mode, quantize)
    frames = _ctx(tmodel.cfg, 11)
    want = rmodel._encode(rparams, jnp.asarray(frames), False)
    got = tmodel._encode(tparams, torch.from_numpy(frames))
    assert got.dtype == tmodel.policy.compute_dtype
    assert tuple(got.shape) == frames.shape
    print(mode, quantize, "encode", _close(got, want, _tol(mode), "enc"),
          "max|enc|", float(np.abs(np.asarray(want, np.float32)).max()))


@pytest.mark.parametrize("mode,quantize", [("w8a8", True), ("fp32", False)])
def test_encoder_is_causal_as_the_reference_is(mode, quantize):
    """ROADMAP C.11: the reference's encoder runs ``self_attention``, which
    is always causal, though its comments call it bidirectional; so a
    change to the last frame leaves every earlier frame's output as it
    was, on both sides (under W8A8 the per-tensor activation scales span
    every frame, so the last frame is only halved: at this seed that
    moves no scale)."""
    rmodel, rparams, tmodel, tparams = _models(AUDIO, mode, quantize)
    frames = _ctx(tmodel.cfg, 12)
    moved = frames.copy()
    moved[:, -1] *= 0.5
    for enc in (lambda f: np.asarray(rmodel._encode(
                    rparams, jnp.asarray(f), False).astype(jnp.float32)),
                lambda f: tmodel._encode(tparams, torch.from_numpy(f))
                .float().numpy()):
        a, b = enc(frames), enc(moved)
        assert np.array_equal(a[:, :-1], b[:, :-1])
        assert not np.array_equal(a[:, -1], b[:, -1])


@pytest.mark.parametrize("mode,quantize", MODES)
def test_forward_and_loss_match_reference(mode, quantize):
    check_forward_and_loss(AUDIO, mode, quantize)


@pytest.mark.parametrize("mode,quantize", [("w8a8", True), ("bf16", False)])
def test_fill_ctx_caches_matches_reference(mode, quantize):
    check_fill_ctx_caches(AUDIO, mode, quantize)


@pytest.mark.parametrize("carried", [False, True])
@pytest.mark.parametrize("mode,quantize", [("w8a8", True), ("bf16", False)])
def test_teacher_forced_decode_matches_reference(mode, quantize, carried):
    check_teacher_forced_decode(AUDIO, mode, quantize, carried)


def test_init_draws_the_reference_layout():
    check_init_layout(AUDIO)


def test_n_params_matches_reference():
    """The reference counts the decoder's gelu MLP as swiglu's three
    matrices and no cross layer (ROADMAP C.11)."""
    cfg = get_config(AUDIO)
    n = check_n_params(AUDIO)
    d, ff = cfg.d_model, cfg.d_ff
    attn = 4 * d * d + 2 * d
    assert n == cfg.vocab * d + cfg.n_layers * (attn + 3 * d * ff + 2 * d) \
        + cfg.encoder_layers * (attn + 2 * d * ff + 2 * d)
    assert r_get_config(AUDIO).n_params() == n


def test_serve_cpu_end_to_end():
    check_serve_cpu(AUDIO)


def test_reference_prefill_and_batcher_leave_context_caches_zero():
    pin_reference_c10(AUDIO)


def test_port_refuses_prefill_batching_and_int8_kv():
    check_port_refusals(AUDIO)
