"""The port's SSM (mamba2) and hybrid (zamba2) families against the JAX
reference.

Inputs are drawn with numpy from a seed, or the params come from the
reference's ``Model.init`` (+ ``quantize_params``), carried across by
``repro_torch.models.convert.from_reference_params``.

Tolerances, with the maxima measured on the CPU (torch 2.13, jax 0.9.0;
``pytest -s`` prints them):

* ``ssd_chunked`` in float32 against the reference's: 1e-5 (measured
  7.6e-6 at |y| up to ~20); against a float64 sequential recurrence:
  1e-4, the reference's own bound (measured 4.1e-6).
* ``causal_conv1d``: 1e-5 against the reference's, full and streaming,
  and the port's streaming steps against its full pass (measured ~5e-7).
* ``mamba2_block`` / ``mamba2_decode``: 1e-5 under ``fp32`` (measured
  2.4e-7); 2e-2 under bf16 and W8A8 (both sides compute in bf16 and round
  elementwise ops at other places; measured <= 7.9e-5).
* ``Model`` of reduced mamba2-130m and zamba2-1.2b in W8A8 (quantized
  weights) and bf16 (float weights): ``forward`` at s = 16 with
  ``ssm_chunk = 4`` (four chunks through the inter-chunk loop), 8
  teacher-forced ``decode_step``s (logits and every cache after each) and
  ``prefill``, all at 2e-2 (measured: logits <= 7.8e-3, one bf16 ulp at
  |logit| in [1, 2); ``state`` <= 1.6e-4, ``conv`` <= 6.6e-3,
  ``shared_k`` / ``shared_v`` <= 6.9e-3).
* The port's decode replay against its own forward at every position:
  5e-2 under the reduced config's bf16 compute (the reference's own
  bound, ``tests/test_ssm.py``; measured 3.9e-3), 1e-4 under ``fp32``
  (measured 3.6e-7).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ALL_ARCHS as R_ALL_ARCHS
from repro.configs import get_config as r_get_config
from repro.configs.base import reduced as r_reduced
from repro.models import ssm as R_ssm
from repro.models.model import Model as RModel
from repro.quant.policy import policy_for as r_policy_for
from repro.serving.scheduler import ContinuousBatcher as RBatcher
from repro.serving.scheduler import Request as RRequest
from repro_torch.configs import get_config
from repro_torch.configs.base import ArchConfig, reduced
from repro_torch.launch.serve import serve
from repro_torch.models import ssm as T_ssm
from repro_torch.models.convert import from_reference_params
from repro_torch.models.model import Model
from repro_torch.quant.policy import policy_for
from repro_torch.serving.scheduler import ContinuousBatcher
from test_torch_serve import _f32, to_numpy_tree

TOL = 2e-2
STEPS = 8
BATCH = 2
ARCHS = ("mamba2-130m", "zamba2-1.2b")
# (mode, quantize): W8A8 with quantized weights, bf16 with float weights
MODES = (("w8a8", True), ("bf16", False))


def _worst(got, want) -> float:
    return float(np.max(np.abs(_f32(got) - _f32(want))))


def _models(arch, mode, quantize, **over):
    rcfg = dataclasses.replace(r_reduced(r_get_config(arch)), quant=mode,
                               **over)
    tcfg = dataclasses.replace(reduced(get_config(arch)), quant=mode, **over)
    rmodel = RModel(rcfg)
    rparams = rmodel.init(jax.random.key(0))
    if quantize:
        rparams = rmodel.quantize_params(rparams)
    tmodel = Model(tcfg, device="cpu")
    tparams = from_reference_params(tcfg, to_numpy_tree(rparams),
                                    device="cpu")
    return rmodel, rparams, tmodel, tparams


# ------------------------------------------------------------------ SSD

def naive_ssm(xh, dt, a_log, B, C):
    """Sequential float64 reference: h_t = exp(dt*A) h_{t-1} + dt*B_t x_t
    (the reference's ``tests/test_ssm.py``)."""
    b, s, h, p = xh.shape
    g, n = B.shape[2], B.shape[3]
    rep = h // g
    A = -np.exp(np.asarray(a_log, np.float64))
    Bh = np.repeat(np.asarray(B, np.float64), rep, axis=2)
    Ch = np.repeat(np.asarray(C, np.float64), rep, axis=2)
    x = np.asarray(xh, np.float64)
    dtn = np.asarray(dt, np.float64)
    state = np.zeros((b, h, p, n))
    ys = np.zeros((b, s, h, p))
    for t in range(s):
        dA = np.exp(dtn[:, t] * A)
        xt = x[:, t] * dtn[:, t][..., None]
        state = state * dA[..., None, None] + \
            np.einsum("bhp,bhn->bhpn", xt, Bh[:, t])
        ys[:, t] = np.einsum("bhpn,bhn->bhp", state, Ch[:, t])
    return ys, state


def _ssd_inputs(seed, b=2, s=16, h=4, p=8, g=1, n=8):
    rng = np.random.default_rng(seed)
    f = np.float32
    xh = rng.standard_normal((b, s, h, p)).astype(f)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(f)
    a_log = (rng.standard_normal(h) * 0.5).astype(f)
    B = rng.standard_normal((b, s, g, n)).astype(f)
    C = rng.standard_normal((b, s, g, n)).astype(f)
    return xh, dt, a_log, B, C


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("chunk", [4, 8, 16])
def test_ssd_chunked_matches_reference_and_naive(chunk):
    ins = _ssd_inputs(0)
    y, final = T_ssm.ssd_chunked(*_t(*ins), chunk=chunk)
    ry, rfinal = R_ssm.ssd_chunked(*map(jnp.asarray, ins), chunk=chunk)
    ny, nfinal = naive_ssm(*ins)
    assert y.dtype == final.dtype == torch.float32
    np.testing.assert_allclose(y.numpy(), np.asarray(ry), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(final.numpy(), np.asarray(rfinal),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(y.numpy(), ny, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(final.numpy(), nfinal, rtol=1e-4, atol=1e-4)
    print(chunk, _worst(y, ry), float(np.abs(y.numpy() - ny).max()))


def test_ssd_init_state_matches_reference_and_threads():
    """Chunked SSD with an initial state equals the reference's, and two
    halves threaded through the state equal the whole sequence."""
    xh, dt, a_log, B, C = _ssd_inputs(7, b=1, s=16, h=2, p=4, n=4)
    y_all, f_all = T_ssm.ssd_chunked(*_t(xh, dt, a_log, B, C), chunk=4)
    h1 = [a[:, :8] for a in (xh, dt)]
    y1, f1 = T_ssm.ssd_chunked(*_t(h1[0], h1[1], a_log, B[:, :8], C[:, :8]),
                               chunk=4)
    args2 = (xh[:, 8:], dt[:, 8:], a_log, B[:, 8:], C[:, 8:])
    y2, f2 = T_ssm.ssd_chunked(*_t(*args2), chunk=4, init_state=f1)
    ry2, rf2 = R_ssm.ssd_chunked(*map(jnp.asarray, args2), chunk=4,
                                 init_state=jnp.asarray(f1.numpy()))
    np.testing.assert_allclose(y2.numpy(), np.asarray(ry2), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(f2.numpy(), np.asarray(rf2), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(torch.cat([y1, y2], 1).numpy(),
                               y_all.numpy(), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(f2.numpy(), f_all.numpy(), rtol=1e-4,
                               atol=1e-4)
    with pytest.raises(ValueError, match="not a multiple"):
        T_ssm.ssd_chunked(*_t(xh, dt, a_log, B, C), chunk=5)


def test_segsum_and_softplus_follow_the_reference():
    rng = np.random.default_rng(3)
    la = rng.standard_normal((3, 6)).astype(np.float32)
    got = T_ssm._segsum(torch.from_numpy(la)).numpy()
    want = np.asarray(R_ssm._segsum(jnp.asarray(la)))
    assert np.array_equal(np.isneginf(got), np.isneginf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-6, atol=1e-6)
    # above F.softplus's threshold of 20 the reference's logaddexp form
    # still adds log1p(exp(-x))
    x = np.array([-30.0, -1.0, 0.0, 3.0, 19.0, 20.5, 40.0], np.float32)
    np.testing.assert_allclose(
        T_ssm._softplus(torch.from_numpy(x)).numpy(),
        np.asarray(jax.nn.softplus(jnp.asarray(x))), rtol=1e-7, atol=0)


def test_causal_conv1d_full_and_streaming_match_reference():
    rng = np.random.default_rng(4)
    b, s, c = 2, 10, 6
    x = rng.standard_normal((b, s, c)).astype(np.float32)
    w = (rng.standard_normal((T_ssm.D_CONV, c)) * 0.5).astype(np.float32)
    full, none = T_ssm.causal_conv1d(*_t(x, w))
    rfull, _ = R_ssm.causal_conv1d(jnp.asarray(x), jnp.asarray(w))
    assert none is None
    np.testing.assert_allclose(full.numpy(), np.asarray(rfull), rtol=1e-5,
                               atol=1e-5)
    cache = torch.zeros((b, T_ssm.D_CONV - 1, c))
    rcache = jnp.zeros((b, T_ssm.D_CONV - 1, c))
    outs = []
    for t in range(s):
        y, cache = T_ssm.causal_conv1d(torch.from_numpy(x[:, t:t + 1]),
                                       torch.from_numpy(w), cache=cache)
        ry, rcache = R_ssm.causal_conv1d(jnp.asarray(x[:, t:t + 1]),
                                         jnp.asarray(w), cache=rcache)
        np.testing.assert_allclose(y.numpy(), np.asarray(ry), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(cache.numpy(), np.asarray(rcache),
                                   rtol=0, atol=0)
        outs.append(y[:, 0])
    np.testing.assert_allclose(torch.stack(outs, 1).numpy(), full.numpy(),
                               rtol=1e-5, atol=1e-5)


# ------------------------------------------------------ the Mamba-2 block

BLOCK_CASES = [("fp32", False, 1e-5), ("bf16", False, TOL),
               ("w8a8", True, TOL)]


@pytest.mark.parametrize("mode,quantize,tol", BLOCK_CASES)
def test_mamba2_block_and_decode_match_reference(mode, quantize, tol):
    _, rparams, tmodel, tparams = _models("mamba2-130m", mode, quantize,
                                          ssm_chunk=4)
    cfg = tmodel.cfg
    rpol, tpol = r_policy_for(mode), policy_for(mode)
    dt_r, dt_t = rpol.compute_dtype, tpol.compute_dtype
    lp_r = jax.tree.map(lambda a: a[0], rparams["layers"])
    lp_t = tparams["layers"][0]
    rng = np.random.default_rng(5)
    x = rng.standard_normal((BATCH, 16, cfg.d_model)).astype(np.float32)
    got = T_ssm.mamba2_block(torch.from_numpy(x).to(dt_t), lp_t, cfg,
                             policy=tpol)
    want = R_ssm.mamba2_block(jnp.asarray(x, dt_r), lp_r, cfg, policy=rpol,
                              train=False)
    assert got.dtype == dt_t
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=tol, atol=tol)
    worst = {"block": _worst(got, want)}
    _, h, _, n = T_ssm.dims(cfg)
    state = rng.standard_normal((BATCH, h, T_ssm.P_HEADDIM, n)) \
        .astype(np.float32)
    conv = rng.standard_normal((BATCH, T_ssm.D_CONV - 1,
                                T_ssm.conv_dim(cfg))).astype(np.float32)
    xt = x[:, :1]
    y, st, cv = T_ssm.mamba2_decode(
        torch.from_numpy(xt).to(dt_t), lp_t, cfg, torch.from_numpy(state),
        torch.from_numpy(conv).to(dt_t), policy=tpol)
    ry, rst, rcv = R_ssm.mamba2_decode(
        jnp.asarray(xt, dt_r), lp_r, cfg, jnp.asarray(state),
        jnp.asarray(conv, dt_r), policy=rpol)
    assert st.dtype == torch.float32 and y.dtype == dt_t
    for name, g, w in (("y", y, ry), ("state", st, rst), ("conv", cv, rcv)):
        np.testing.assert_allclose(_f32(g), _f32(w), rtol=tol, atol=tol,
                                   err_msg=name)
        worst[name] = _worst(g, w)
    print(mode, worst)


# ------------------------------------------------------------ the models

MODEL_CASES = [(a, m, q) for a in ARCHS for m, q in MODES]


@pytest.mark.parametrize("arch,mode,quantize", MODEL_CASES)
def test_forward_matches_reference(arch, mode, quantize):
    rmodel, rparams, tmodel, tparams = _models(arch, mode, quantize,
                                               ssm_chunk=4)
    tokens = np.random.default_rng(1).integers(0, tmodel.cfg.vocab,
                                               (BATCH, 16))
    rlog, _ = rmodel.forward(rparams, jnp.asarray(tokens, jnp.int32))
    tlog, aux = tmodel.forward(tparams, torch.from_numpy(tokens))
    assert tlog.dtype == torch.bfloat16 and float(aux) == 0.0
    assert tuple(tlog.shape) == (BATCH, 16, tmodel.cfg.vocab)
    np.testing.assert_allclose(_f32(tlog), _f32(rlog), rtol=TOL, atol=TOL)
    last, _ = tmodel.forward(tparams, torch.from_numpy(tokens),
                             last_only=True)
    assert torch.equal(last, tlog[:, -1:])
    print(arch, mode, _worst(tlog, rlog))


@pytest.mark.parametrize("arch,mode,quantize", MODEL_CASES)
def test_decode_matches_reference(arch, mode, quantize):
    rmodel, rparams, tmodel, tparams = _models(arch, mode, quantize)
    cfg = tmodel.cfg
    tokens = np.random.default_rng(2).integers(0, cfg.vocab, (BATCH, STEPS))
    rcache = rmodel.init_cache(BATCH, STEPS)
    tcache = tmodel.init_cache(BATCH, STEPS)
    want_keys = {"state", "conv"} | ({"shared_k", "shared_v"}
                                     if cfg.family == "hybrid" else set())
    assert set(tcache) == set(rcache) == want_keys
    for k in tcache:
        assert tuple(tcache[k].shape) == tuple(rcache[k].shape), k
    decode = jax.jit(rmodel.decode_step)
    worst = {}
    for i in range(STEPS):
        rlog, rcache = decode(rparams, rcache,
                              jnp.asarray(tokens[:, i:i + 1], jnp.int32),
                              jnp.int32(i))
        tlog, tcache = tmodel.decode_step(
            tparams, tcache, torch.from_numpy(tokens[:, i:i + 1]), i)
        assert tuple(tlog.shape) == (BATCH, 1, cfg.vocab)
        for name, r, t in [("logits", rlog, tlog)] + \
                [(k, rcache[k], tcache[k]) for k in sorted(want_keys)]:
            worst[name] = max(worst.get(name, 0.0), _worst(t, r))
            np.testing.assert_allclose(_f32(t), _f32(r), rtol=TOL, atol=TOL,
                                       err_msg=f"{name} at step {i}")
    assert tcache["state"].dtype == torch.float32
    assert tcache["conv"].dtype == torch.bfloat16
    print(arch, mode, quantize, worst)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_matches_reference(arch):
    rmodel, rparams, tmodel, tparams = _models(arch, "w8a8", True,
                                               ssm_chunk=4)
    tokens = np.random.default_rng(3).integers(0, tmodel.cfg.vocab,
                                               (BATCH, 8))
    rlog, rc = rmodel.prefill(rparams, jnp.asarray(tokens, jnp.int32),
                              max_seq=10)
    tlog, tc = tmodel.prefill(tparams, torch.from_numpy(tokens), max_seq=10)
    np.testing.assert_allclose(_f32(tlog), _f32(rlog), rtol=TOL, atol=TOL)
    assert set(tc) == set(rc)
    for k in tc:
        assert tc[k].dtype == (torch.float32 if k == "state"
                               else torch.bfloat16)
        np.testing.assert_allclose(_f32(tc[k]), _f32(rc[k]), rtol=TOL,
                                   atol=TOL, err_msg=k)


@pytest.mark.parametrize("arch,mode,tol", [
    ("mamba2-130m", "w8a8", 5e-2), ("zamba2-1.2b", "w8a8", 5e-2),
    ("mamba2-130m", "fp32", 1e-4), ("zamba2-1.2b", "fp32", 1e-4)])
def test_decode_replay_matches_own_forward(arch, mode, tol):
    """Decoding token by token equals the chunked forward at every
    position (float weights: bf16 compute under the reduced config's
    w8a8, float32 under fp32)."""
    cfg = dataclasses.replace(reduced(get_config(arch)), quant=mode,
                              ssm_chunk=4)
    model = Model(cfg, device="cpu")
    params = model.init(torch.Generator("cpu").manual_seed(0))
    s = 8
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (BATCH, s)))
    full, _ = model.forward(params, toks)
    caches = model.init_cache(BATCH, s, dtype=model.policy.compute_dtype)
    outs = []
    for i in range(s):
        logits, caches = model.decode_step(params, caches, toks[:, i:i + 1],
                                           i)
        outs.append(logits[:, 0])
    dec = torch.stack(outs, 1)
    np.testing.assert_allclose(_f32(dec), _f32(full), rtol=tol, atol=tol)
    print(arch, mode, _worst(dec, full))


def test_fp32_decode_on_a_bf16_cache_keeps_the_references_dtypes():
    """Under fp32 on the default bf16 cache the reference's ssm layer scan
    leaves ``conv`` float32 and its hybrid keeps it bf16."""
    for arch, want in (("mamba2-130m", torch.float32),
                       ("zamba2-1.2b", torch.bfloat16)):
        rmodel, rparams, tmodel, tparams = _models(arch, "fp32", False)
        tc = tmodel.init_cache(BATCH, 4)
        rc = rmodel.init_cache(BATCH, 4)
        tok = np.ones((BATCH, 1), np.int64)
        for i in range(2):
            tlog, tc = tmodel.decode_step(tparams, tc, torch.from_numpy(tok),
                                          i)
            rlog, rc = rmodel.decode_step(rparams, rc,
                                          jnp.asarray(tok, jnp.int32), i)
        assert tc["conv"].dtype == want
        assert str(want).split(".")[-1] == jnp.dtype(rc["conv"].dtype).name
        np.testing.assert_allclose(_f32(tc["conv"]), _f32(rc["conv"]),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(_f32(tlog), _f32(rlog), rtol=1e-5,
                                   atol=1e-5)


# --------------------------------------------------- params and configs

@pytest.mark.parametrize("arch", ARCHS)
def test_quantize_params_bit_identical(arch):
    """The port quantizes the reference's float params, the hybrid's
    unstacked shared block too, to the reference's integers and scales;
    ``conv_w``, norms and SSM vectors stay float."""
    rmodel, rparams, tmodel, tparams = _models(arch, "w8a8", False)
    want = from_reference_params(
        tmodel.cfg, to_numpy_tree(rmodel.quantize_params(rparams)),
        device="cpu")
    got = tmodel.quantize_params(tparams)
    blocks = [(g, w) for g, w in zip(got["layers"], want["layers"])]
    if "shared" in want:
        blocks.append((got["shared"], want["shared"]))
    for lg, lw in blocks:
        assert lg.keys() == lw.keys()
        for name in lg:
            if isinstance(lw[name], torch.Tensor):
                assert torch.equal(lg[name], lw[name]), name
                continue
            assert lg[name].orig_shape == lw[name].orig_shape
            assert lg[name].data.dim() == 2
            assert torch.equal(lg[name].data, lw[name].data), name
            assert torch.equal(lg[name].scale, lw[name].scale), name
    n_quantized = sum(not isinstance(v, torch.Tensor)
                      for lp, _ in blocks for v in lp.values())
    assert n_quantized == 2 * tmodel.cfg.n_layers + (
        7 if tmodel.cfg.family == "hybrid" else 0)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_draws_the_reference_layout(arch):
    """``init`` draws every leaf of the reference's layout, with its
    shapes and constants, quantizing layer by layer."""
    rmodel, rparams, _, _ = _models(arch, "w8a8", False)
    cfg = reduced(get_config(arch))
    model = Model(cfg, device="cpu")
    params = model.init(torch.Generator("cpu").manual_seed(0))
    want = to_numpy_tree(rparams)
    assert params.keys() == want.keys()
    for l, lp in enumerate(params["layers"]):
        assert lp.keys() == want["layers"].keys()
        for name, t in lp.items():
            assert tuple(t.shape) == want["layers"][name].shape[1:], name
    for name in ("dt_bias", "a_log", "d_skip"):
        want_vec = np.array(want["layers"][name][0])
        assert torch.equal(params["layers"][0][name],
                           torch.from_numpy(want_vec))
    if "shared" in want:
        assert {k: tuple(v.shape) for k, v in params["shared"].items()} == \
            {k: v.shape for k, v in want["shared"].items()}
    q = model.init(torch.Generator("cpu").manual_seed(0), quantize=True)
    again = model.quantize_params(params)
    assert torch.equal(q["layers"][1]["in_proj"].data,
                       again["layers"][1]["in_proj"].data)
    if "shared" in q:
        assert torch.equal(q["shared"]["wo"].data, again["shared"]["wo"].data)


def test_convert_refuses_trees_of_another_family():
    _, rparams, tmodel, _ = _models("zamba2-1.2b", "w8a8", True)
    tree = to_numpy_tree(rparams)
    ssm_cfg = reduced(get_config("mamba2-130m"))
    with pytest.raises(ValueError, match="keys"):       # has "shared"
        from_reference_params(ssm_cfg, tree, device="cpu")
    with pytest.raises(ValueError, match="keys"):       # lacks "shared"
        from_reference_params(
            tmodel.cfg, dict(tree, shared={"ln1": tree["shared"]["ln1"]}),
            device="cpu")
    dense = reduced(get_config("phi4-mini-3.8b"))
    with pytest.raises(ValueError, match="keys"):
        from_reference_params(dense, {k: v for k, v in tree.items()
                                      if k != "shared"}, device="cpu")


@pytest.mark.parametrize("arch", R_ALL_ARCHS)
def test_reduced_matches_reference_for_every_arch(arch):
    """``reduced`` gives every reference arch's family the reference's
    small config, field for field (the port's ``ArchConfig`` built from
    the reference config's fields), and ``n_params`` agrees for every
    family (``n_active_params`` too: the MoE family's)."""
    r = r_get_config(arch)
    t = ArchConfig(**dataclasses.asdict(r))
    assert dataclasses.asdict(reduced(t)) == dataclasses.asdict(r_reduced(r))
    assert dataclasses.asdict(reduced(t, n_layers=3)) == \
        dataclasses.asdict(r_reduced(r, n_layers=3))
    assert t.n_params() == r.n_params()
    assert reduced(t).n_params() == r_reduced(r).n_params()
    assert t.n_active_params() == r.n_active_params()
    assert reduced(t).n_active_params() == r_reduced(r).n_active_params()


# ------------------------------------------------------ serving limits

@pytest.mark.parametrize("arch", ARCHS)
def test_int8_kv_and_batching_refused(arch):
    model = Model(reduced(get_config(arch)), device="cpu")
    with pytest.raises(NotImplementedError, match="int8 KV"):
        model.init_cache(2, 8, kv_quant=True)
    params = model.init(torch.Generator("cpu").manual_seed(0))
    with pytest.raises(NotImplementedError, match="ROADMAP C.8"):
        ContinuousBatcher(model, params, n_slots=2, max_seq=16)


def test_reference_batcher_leaks_ssm_state_on_slot_reuse():
    """ROADMAP C.8, pinned on the reference: a one-slot batcher that
    serves request B after A leaves a different state than B served
    alone, because ``_admit`` resets positions but not the SSM caches.
    If this starts failing, the reference changed: revisit the port's
    refusal."""
    cfg = r_reduced(r_get_config("mamba2-130m"))
    model = RModel(cfg)
    params = model.init(jax.random.key(0))
    rng = np.random.default_rng(9)
    prompt_a = [int(t) for t in rng.integers(0, cfg.vocab, 6)]
    prompt_b = [int(t) for t in rng.integers(0, cfg.vocab, 5)]

    def serve_b(after_a: bool):
        bat = RBatcher(model, params, n_slots=1, max_seq=32)
        if after_a:
            bat.submit(RRequest(rid=0, prompt=prompt_a, max_new=3))
        bat.submit(RRequest(rid=1, prompt=prompt_b, max_new=3))
        done = bat.run()
        assert [r.rid for r in done] == ([0, 1] if after_a else [1])
        return np.asarray(bat.caches["state"]), np.asarray(
            bat.caches["conv"], np.float32)
    st_alone, cv_alone = serve_b(False)
    st_after, cv_after = serve_b(True)
    assert not np.array_equal(st_alone, st_after)
    print("state drift after A:", float(np.abs(st_alone - st_after).max()),
          "conv:", float(np.abs(cv_alone - cv_after).max()))


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cpu_end_to_end(arch):
    res = serve(arch, batch=2, prompt_len=4, gen=5, quantize=True,
                device="cpu")
    toks = res["tokens"]
    assert toks.dtype == torch.int32 and tuple(toks.shape) == (2, 5)
    assert int(toks.min()) >= 0 and int(toks.max()) < 256
    again = serve(arch, batch=2, prompt_len=4, gen=5, quantize=True,
                  device="cpu")
    assert torch.equal(again["tokens"], toks)
