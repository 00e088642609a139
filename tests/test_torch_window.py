"""The port's windowed dense family (gemma3) against the JAX reference:
the ring-buffer mask, ``decode_self_attention``'s ring, slice and dynamic
window branches, ``chunked_attention`` and ``attend``'s plain route, and
reduced gemma3's forward, teacher-forced decode past the ring's wrap,
prefill, caches and continuous batching.

Params come from the reference (``Model.init``, ``quantize_params``) and
are carried over by ``repro_torch.models.convert``; inputs are drawn with
numpy from a seed.  Bounds, each the dense family's:

* ``chunked_attention`` vs the reference's, float32: rtol = atol = 1e-5,
  the reference's own bound against dense attention
  (``tests/test_attention.py``).
* decode attention, forward, decode logits and caches (int8 ones
  dequantized), bf16: 2e-2, the bound of ``tests/test_torch_serve.py``.
* the port's decode replayed over 20 tokens vs its own forward: 5e-2 x
  max|logit|, the bound ``tests/test_perf_paths.py`` holds the reference
  to.
* the batcher: the greedy tokens of every request equal the reference
  batcher's (bf16 KV), and >= 0.6 of them with int8 KV, the reference's
  own agreement bound (``tests/test_scheduler.py``) for int8 caches,
  whose codes a one-ulp bf16 difference can move.

``pytest -s`` prints each run's maxima.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as R_attn
from repro.quant.policy import policy_for as r_policy_for
from repro.serving.scheduler import ContinuousBatcher as RBatcher
from repro.serving.scheduler import Request as RRequest
from repro_torch.configs import get_config
from repro_torch.configs.base import reduced
from repro_torch.models import attention as T_attn
from repro_torch.models.convert import from_reference_cache
from repro_torch.models.model import Model, layer_windows
from repro_torch.quant.policy import policy_for
from repro_torch.serving.scheduler import ContinuousBatcher, Request
from test_torch_serve import _f32, _models, to_numpy_tree

TOL = 2e-2
CHUNK_TOL = 1e-5
ARCH = "gemma3-4b"


# ------------------------------------------------------ the ring's mask

@pytest.mark.parametrize("W", [1, 2, 3, 8, 1024])
def test_ring_mask_is_slot_up_to_pos(W):
    """A ring slot r holds position ki = pos - ((pos - r) mod W); the
    reference keeps it where ki <= pos and ki >= 0.  That is r <= pos,
    the int8 decode kernel's own mask, at every pos < 3W."""
    pos = jnp.arange(3 * W)[:, None]
    r = jnp.arange(W)[None, :]
    ki = pos - jnp.remainder(pos - r, W)
    ref = np.asarray((ki <= pos) & (ki >= 0))
    assert np.array_equal(ref, np.asarray(r <= pos))


# ------------------------------------------------ decode_self_attention

def _layer():
    """An attention layer of reduced gemma3 with float weights at scale
    d_in^-0.5, so that q, k, v and the output are O(1) and the bf16
    bound of 2e-2 is a few ulps of them."""
    cfg = reduced(get_config(ARCH))
    d, h, kvh, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    rng = np.random.default_rng(7)
    lp = {name: (rng.standard_normal(shape) / np.sqrt(shape[0]))
          .astype(np.float32)
          for name, shape in (("wq", (d, h * hd)), ("wk", (d, kvh * hd)),
                              ("wv", (d, kvh * hd)), ("wo", (h * hd, d)))}
    return ({k: jnp.asarray(v) for k, v in lp.items()},
            {k: torch.from_numpy(v) for k, v in lp.items()}, cfg)


DECODE_MODES = {
    # (S, static_window, window)
    "ring": (8, 8, None),
    "slice": (24, 8, None),
    "window": (24, None, 5),
    "ring_window": (8, 8, 5),
}


def _dequant(cache, scale):
    return _f32(cache) * _f32(scale)[..., None]


@pytest.mark.parametrize("mode", sorted(DECODE_MODES))
@pytest.mark.parametrize("kv", ["bf16", "int8"])
@pytest.mark.parametrize("per_slot", [False, True])
def test_decode_window_modes_match_reference(mode, kv, per_slot):
    """17 steps from one cache on both sides, positions up to 23 (a ring
    of 8 wraps twice), scalar or per-slot (offsets 0, 3, 7): the output
    and every cache after each step."""
    S, sw, window = DECODE_MODES[mode]
    lp_r, lp_t, cfg = _layer()
    b, steps = 3, 17
    offs = np.array([0, 3, 7], np.int32) if per_slot else np.zeros(b, np.int32)
    kvh, hd = cfg.n_kv_heads, cfg.head_dim
    rng = np.random.default_rng(sorted(DECODE_MODES).index(mode))
    if kv == "int8":
        rc = [jnp.zeros((b, S, kvh, hd), jnp.int8)] * 2 \
            + [jnp.zeros((b, S, kvh), jnp.float32)] * 2
        tc = [torch.zeros((b, S, kvh, hd), dtype=torch.int8) for _ in "kv"] \
            + [torch.zeros((b, S, kvh)) for _ in "kv"]
    else:
        rc = [jnp.zeros((b, S, kvh, hd), jnp.bfloat16)] * 2
        tc = [torch.zeros((b, S, kvh, hd), dtype=torch.bfloat16)
              for _ in "kv"]
    worst = 0.0
    for i in range(steps):
        x = rng.standard_normal((b, 1, cfg.d_model)).astype(np.float32)
        rpos = jnp.asarray(offs + i) if per_slot else jnp.int32(i)
        tpos = torch.from_numpy(offs + i) if per_slot else i
        kw = dict(window=window, static_window=sw)
        res_r = R_attn.decode_self_attention(
            jnp.asarray(x, jnp.bfloat16), lp_r, cfg, rc[0], rc[1], rpos,
            policy=r_policy_for("bf16"),
            kv_scales=tuple(rc[2:]) if kv == "int8" else None, **kw)
        res_t = T_attn.decode_self_attention(
            torch.from_numpy(x).to(torch.bfloat16), lp_t, cfg, tc[0], tc[1],
            tpos, policy=policy_for("bf16"),
            kv_scales=tuple(tc[2:]) if kv == "int8" else None, **kw)
        rc = list(res_r[1:3]) + (list(res_r[3]) if kv == "int8" else [])
        pairs = [("out", _f32(res_r[0]), _f32(res_t[0]))]
        if kv == "int8":
            pairs += [("k", _dequant(rc[0], rc[2]), _dequant(tc[0], tc[2])),
                      ("v", _dequant(rc[1], rc[3]), _dequant(tc[1], tc[3]))]
        else:
            pairs += [("k", _f32(rc[0]), _f32(tc[0])),
                      ("v", _f32(rc[1]), _f32(tc[1]))]
        for name, r, t in pairs:
            worst = max(worst, float(np.max(np.abs(r - t))))
            np.testing.assert_allclose(t, r, rtol=TOL, atol=TOL,
                                       err_msg=f"{name} at step {i}")
    print(mode, kv, per_slot, worst)


def test_ring_decode_equals_slice_of_a_full_cache():
    """On the port alone: a ring of 8 and a full cache of 24 read through
    the slice branch give the same output at every step, bf16 and int8,
    per-slot positions past the wrap."""
    _, lp, cfg = _layer()
    b, W, S = 3, 8, 24
    offs = torch.tensor([0, 3, 7])
    kvh, hd = cfg.n_kv_heads, cfg.head_dim
    rng = np.random.default_rng(5)
    for kv in ("bf16", "int8"):
        def caches(n):
            if kv == "bf16":
                return [torch.zeros((b, n, kvh, hd), dtype=torch.bfloat16)
                        for _ in "kv"], None
            return ([torch.zeros((b, n, kvh, hd), dtype=torch.int8)
                     for _ in "kv"], [torch.zeros((b, n, kvh)) for _ in "kv"])
        (rk, rv), rs = caches(W)
        (fk, fv), fs = caches(S)
        for i in range(S - 7):
            x = torch.from_numpy(rng.standard_normal((b, 1, cfg.d_model))
                                 .astype(np.float32)).to(torch.bfloat16)
            ring = T_attn.decode_self_attention(
                x, lp, cfg, rk, rv, offs + i, policy=policy_for("bf16"),
                static_window=W, kv_scales=rs)[0]
            full = T_attn.decode_self_attention(
                x, lp, cfg, fk, fv, offs + i, policy=policy_for("bf16"),
                static_window=W, kv_scales=fs)[0]
            np.testing.assert_allclose(_f32(ring), _f32(full), rtol=TOL,
                                       atol=TOL, err_msg=f"{kv} step {i}")
            if i < W - 7:        # no slot has wrapped: the same order
                assert torch.equal(ring, full)


# ----------------------------------------------------- chunked attention

CHUNK_CASES = {
    # (sq, sk, causal, window)
    "causal_grouped_skip": (128, 128, True, None),
    "windowed": (128, 128, True, 24),
    "non_causal": (64, 64, False, None),
    "prime_37": (37, 37, True, None),
    "ragged_group": (80, 80, True, None),
    "cross_lengths": (32, 96, True, 40),
}


@pytest.mark.parametrize("case", sorted(CHUNK_CASES))
def test_chunked_attention_matches_reference(case):
    """bq = bk = 16: 8 q blocks in two groups of the causal skip; 5 q
    blocks (a group of 4, then 1); a window; the non-causal map; 37
    (prime: one block); sq < sk."""
    sq, sk, causal, window = CHUNK_CASES[case]
    rng = np.random.default_rng(sq + sk)
    q, k, v = (rng.standard_normal((2, s, 4, 16)).astype(np.float32)
               for s in (sq, sk, sk))
    want = R_attn.chunked_attention(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), causal=causal,
                                    window=window, bq=16, bk=16)
    got = T_attn.chunked_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                                   causal=causal, window=window, bq=16, bk=16)
    err = float(np.max(np.abs(got.numpy() - np.asarray(want))))
    print(case, "chunked vs reference", err)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=CHUNK_TOL, atol=CHUNK_TOL)
    dense = T_attn.dense_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                                   causal=causal, window=window)
    np.testing.assert_allclose(got.numpy(), dense.numpy(), rtol=CHUNK_TOL,
                               atol=CHUNK_TOL)


@pytest.mark.parametrize("length,route", [(2048, "dense"),
                                          (2049, "chunked")])
def test_attend_plain_route_dense_then_chunked(monkeypatch, length, route):
    """The plain route is dense up to DENSE_SEQ_LIMIT = 2048 keys and
    chunked above, as the reference's ``attend``; the card's is flash."""
    assert T_attn.DENSE_SEQ_LIMIT == R_attn.DENSE_SEQ_LIMIT == 2048
    calls = []
    for name in ("dense_attention", "chunked_attention"):
        monkeypatch.setattr(T_attn, name,
                            lambda q, *a, _n=name, **k: calls.append(_n) or q)
    q = torch.zeros((1, 1, 1, 16))
    k = torch.zeros((1, length, 1, 16))
    T_attn.attend(q, k, k, window=8)
    assert calls == [f"{route}_attention"]


# ------------------------------------------------------- reduced gemma3

def _pair(mode="w8a8", quantize=True):
    return _models(ARCH, mode, quantize)


def test_model_layers_and_caches():
    """Per-layer windows (local: the window; every global_every-th: None)
    and the caches' keys, shapes and dtypes, the reference's."""
    full = get_config(ARCH)
    wins = layer_windows(full)
    assert [l for l, w in enumerate(wins) if w is None] == [5, 11, 17, 23, 29]
    assert set(wins) == {None, 1024}
    rmodel, _, tmodel, _ = _pair()
    for kv_quant in (False, True):
        for max_seq in (6, 64):
            want = rmodel.init_cache(2, max_seq, kv_quant=kv_quant)
            got = tmodel.init_cache(2, max_seq, kv_quant=kv_quant)
            assert set(got) == set(want)
            for name, t in got.items():
                assert tuple(t.shape) == want[name].shape, name
                assert str(t.dtype).split(".")[-1] == want[name].dtype.name
    c = tmodel.init_cache(2, 64)
    assert c["k_local"].shape[2] == tmodel.cfg.window == 8
    assert c["k"].shape[0] == 1 and c["k_local"].shape[0] == 1


def test_full_config_builds_serves_and_prefills_on_cpu():
    """gemma3-4b's full config builds on the CPU; one layer of each kind
    at full width serves and prefills there."""
    cfg = dataclasses.replace(get_config(ARCH), n_layers=2, global_every=2,
                              vocab=512)
    model = Model(cfg, device="cpu")
    params = model.init(torch.Generator("cpu").manual_seed(0), quantize=True)
    toks = torch.randint(0, cfg.vocab, (1, 3),
                         generator=torch.Generator("cpu").manual_seed(1))
    logits, caches = model.prefill(params, toks, max_seq=4)
    assert tuple(logits.shape) == (1, 3, cfg.vocab)
    assert bool(torch.isfinite(logits).all())
    assert tuple(caches["k_local"].shape) == (1, 1, 4, 4, 256)
    step, _ = model.decode_step(params, caches, toks[:, -1:], 3)
    assert bool(torch.isfinite(step).all())
    Model(get_config(ARCH), device="cpu")


@pytest.mark.parametrize("mode,quantize", [("w8a8", True), ("bf16", False)])
def test_forward_matches_reference(mode, quantize):
    """s = 20 > window = 8: the local layer's mask cuts."""
    rmodel, rparams, tmodel, tparams = _pair(mode, quantize)
    tokens = np.random.default_rng(2).integers(0, tmodel.cfg.vocab, (2, 20))
    want, _ = jax.jit(lambda p, t: rmodel.forward(p, t, train=False))(
        rparams, jnp.asarray(tokens, jnp.int32))
    got, _ = tmodel.forward(tparams, torch.from_numpy(tokens))
    err = float(np.max(np.abs(_f32(got) - _f32(want))))
    print(mode, "forward logits", err)
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=TOL, atol=TOL)


def _compare_caches(rcache, tcache, kv_quant, where):
    """Every KV cache (int8 ones dequantized) within the bf16 bound."""
    worst = {}
    for name in ("k", "v", "k_local", "v_local"):
        if kv_quant:
            r = _dequant(rcache[name], rcache[f"{name}_scale"])
            t = _dequant(tcache[name], tcache[f"{name}_scale"])
        else:
            r, t = _f32(rcache[name]), _f32(tcache[name])
        worst[name] = float(np.max(np.abs(r - t)))
        np.testing.assert_allclose(t, r, rtol=TOL, atol=TOL,
                                   err_msg=f"{name} {where}")
    return worst


@pytest.mark.parametrize("kv_quant", [False, True])
@pytest.mark.parametrize("per_slot", [False, True])
def test_teacher_forced_decode_past_the_wrap(kv_quant, per_slot):
    """20 steps (s = 20 > W = 8) through both ``decode_step``s, W8A8
    params as configured, positions shared or per slot (offsets 0, 2,
    5): logits and every cache after each step."""
    rmodel, rparams, tmodel, tparams = _pair()
    b, steps = 3, 20
    offs = np.array([0, 2, 5], np.int32) if per_slot else np.zeros(b, np.int32)
    S = steps + int(offs.max())
    tokens = np.random.default_rng(1).integers(0, tmodel.cfg.vocab,
                                               (b, steps))
    rcache = rmodel.init_cache(b, S, kv_quant=kv_quant)
    tcache = tmodel.init_cache(b, S, kv_quant=kv_quant)
    decode = jax.jit(rmodel.decode_step)
    worst = {"logits": 0.0}
    for i in range(steps):
        tok = tokens[:, i:i + 1]
        rpos = jnp.asarray(offs + i) if per_slot else jnp.int32(i)
        tpos = torch.from_numpy(offs + i) if per_slot else i
        rlog, rcache = decode(rparams, rcache, jnp.asarray(tok, jnp.int32),
                              rpos)
        tlog, tcache = tmodel.decode_step(tparams, tcache,
                                          torch.from_numpy(tok), tpos)
        err = float(np.max(np.abs(_f32(rlog) - _f32(tlog))))
        worst["logits"] = max(worst["logits"], err)
        np.testing.assert_allclose(_f32(tlog), _f32(rlog), rtol=TOL,
                                   atol=TOL, err_msg=f"logits at step {i}")
        for k, e in _compare_caches(rcache, tcache, kv_quant,
                                    f"at step {i}").items():
            worst[k] = max(worst.get(k, 0.0), e)
    print(kv_quant, per_slot, worst)


@pytest.mark.parametrize("kv_quant", [False, True])
def test_decode_from_a_carried_reference_cache(kv_quant):
    """The reference's caches after 12 steps, carried over by
    ``from_reference_cache``: 4 more steps from that state on both sides
    agree on the logits and every cache."""
    rmodel, rparams, tmodel, tparams = _pair()
    b, steps = 2, 16
    tokens = np.random.default_rng(4).integers(0, tmodel.cfg.vocab,
                                               (b, steps))
    rcache = rmodel.init_cache(b, steps, kv_quant=kv_quant)
    decode = jax.jit(rmodel.decode_step)
    for i in range(12):
        _, rcache = decode(rparams, rcache,
                           jnp.asarray(tokens[:, i:i + 1], jnp.int32),
                           jnp.int32(i))
    tcache = from_reference_cache(tmodel, to_numpy_tree(rcache), device="cpu")
    for name, t in tcache.items():
        assert np.array_equal(_f32(t), _f32(rcache[name])), name
    for i in range(12, steps):
        tok = tokens[:, i:i + 1]
        rlog, rcache = decode(rparams, rcache, jnp.asarray(tok, jnp.int32),
                              jnp.int32(i))
        tlog, tcache = tmodel.decode_step(tparams, tcache,
                                          torch.from_numpy(tok), i)
        np.testing.assert_allclose(_f32(tlog), _f32(rlog), rtol=TOL,
                                   atol=TOL)
        _compare_caches(rcache, tcache, kv_quant, f"at step {i}")
    with pytest.raises(ValueError, match="keys"):
        from_reference_cache(tmodel, {**to_numpy_tree(rcache), "x": 0},
                             device="cpu")


@pytest.mark.parametrize("kv_quant", [False, True])
def test_decode_equals_own_forward(kv_quant):
    """The port's decode replayed over s = 20 > W = 8 against its own
    forward, as ``tests/test_perf_paths.py`` holds the reference."""
    _, _, tmodel, tparams = _pair("bf16", False)
    s = 20
    toks = torch.from_numpy(
        np.random.default_rng(1).integers(0, tmodel.cfg.vocab, (2, s)))
    full, _ = tmodel.forward(tparams, toks)
    caches = tmodel.init_cache(2, s, kv_quant=kv_quant)
    outs = []
    for i in range(s):
        lg, caches = tmodel.decode_step(tparams, caches, toks[:, i:i + 1], i)
        outs.append(lg[:, 0])
    dec = torch.stack(outs, 1).float()
    rel = float((dec - full.float()).abs().max() / full.float().abs().max())
    print(kv_quant, "decode vs forward", rel)
    assert rel < 5e-2


def test_prefill_matches_reference():
    """``prefill`` at max_seq 24 over 12 prompt tokens: logits and every
    cache against the reference's, and equal to the port's own replay."""
    rmodel, rparams, tmodel, tparams = _pair()
    toks = np.random.default_rng(3).integers(0, tmodel.cfg.vocab, (2, 12))
    rlog, rcache = rmodel.prefill(rparams, jnp.asarray(toks, jnp.int32),
                                  max_seq=24)
    tlog, tcache = tmodel.prefill(tparams, torch.from_numpy(toks),
                                  max_seq=24)
    np.testing.assert_allclose(_f32(tlog), _f32(rlog), rtol=TOL, atol=TOL)
    assert set(tcache) == set(rcache)
    _compare_caches(rcache, tcache, False, "after prefill")
    assert tcache["k_local"].shape[2] == 8 and tcache["k"].shape[2] == 24
    want = tmodel.init_cache(2, 24)
    for i in range(12):
        _, want = tmodel.decode_step(tparams, want,
                                     torch.from_numpy(toks[:, i:i + 1]), i)
    for name in want:
        assert torch.equal(tcache[name], want[name]), name


# ------------------------------------------------------------- batching

def _requests(cls, vocab):
    rng = np.random.default_rng(0)
    # 2 slots, 3 requests: queuing and slot reuse; the second request runs
    # to position 17, past the ring of 8
    return [cls(rid=i, prompt=[int(t) for t in rng.integers(0, vocab, n)],
                max_new=g)
            for i, (n, g) in enumerate([(3, 4), (11, 7), (2, 9)])]


@pytest.mark.parametrize("kv_quant", [False, True])
def test_batcher_matches_reference_batcher(kv_quant):
    rmodel, rparams, tmodel, tparams = _pair()
    max_seq = 24
    rb = RBatcher(rmodel, rparams, n_slots=2, max_seq=max_seq,
                  kv_quant=kv_quant)
    tb = ContinuousBatcher(tmodel, tparams, n_slots=2, max_seq=max_seq,
                           kv_quant=kv_quant)
    assert tb.caches["k_local"].shape[2] == 8
    rreqs = _requests(RRequest, tmodel.cfg.vocab)
    treqs = _requests(Request, tmodel.cfg.vocab)
    for r in rreqs:
        rb.submit(r)
    for r in treqs:
        tb.submit(r)
    rb.run()
    tb.run()
    agree = []
    for r, t in zip(rreqs, treqs):
        assert t.done and len(t.generated) == t.max_new
        assert (t.submit_iter, t.complete_iter) == \
            (r.submit_iter, r.complete_iter)
        agree.append(np.mean(np.asarray(t.generated)
                             == np.asarray(r.generated)))
    print(kv_quant, "greedy agreement", agree)
    if kv_quant:
        assert min(agree) >= 0.6
    else:
        assert min(agree) == 1.0


def test_batcher_reused_slot_equals_isolated_request():
    """On the port alone: with 1 slot, a request served after one that
    wrapped the ring gives the tokens it gives alone."""
    _, _, tmodel, tparams = _pair()
    first, second = _requests(Request, tmodel.cfg.vocab)[1:]
    bat = ContinuousBatcher(tmodel, tparams, n_slots=1, max_seq=24)
    bat.submit(first)
    bat.submit(second)
    bat.run()
    alone = ContinuousBatcher(tmodel, tparams, n_slots=1, max_seq=24)
    again = Request(rid=9, prompt=second.prompt, max_new=second.max_new)
    alone.submit(again)
    alone.run()
    assert again.generated == second.generated
