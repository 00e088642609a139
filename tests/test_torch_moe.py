"""The port's MoE family (moonshot-v1-16b-a3b, phi3.5-moe-42b-a6.6b)
against the JAX reference: ``topk_route``, the sort-based ``moe_ffn`` at
decode and prefill capacities, its combine, reduced models' forward,
loss, teacher-forced decode on bf16 and int8 caches and prefill, the
serving storage of the experts, and ROADMAP C.9.

Inputs are drawn with numpy from a seed, or the params come from the
reference's ``Model.init`` (+ ``quantize_params``), carried across by
``repro_torch.models.convert``.  Bounds, with the maxima measured on the
CPU (torch 2.13, jax 0.9.0; ``pytest -s`` prints them):

* routing: experts identical to the reference's wherever the gap
  between the k-th and (k+1)-th router probability exceeds ``MARGIN =
  1e-5`` (the float32 router products of the two frameworks sum in other
  orders, ~1e-7 apart; under bf16 compute a one-ulp difference of the
  normed input moves a probability by ~3e-5 at most at these widths);
  the smallest gap seen is printed, and every model and ``moe_ffn``
  input here clears the margin (smallest measured: 1.27e-5, ``moe_ffn``
  at C = 1; 6.0e-5 in a reduced forward).  Gates within 1e-6 of the
  reference's, relative to their sum of 1 (a small gate carries its
  logit's float32 rounding: measured 1.9e-7 absolute, 2.4e-6 relative
  on a gate of 0.02); ``aux`` within 1e-6 (measured 1.2e-7).
* ``moe_ffn``: 1e-5 under ``fp32`` (measured 4.8e-7 at |out| ~ 2); 2e-2
  under bf16 (XLA's bf16 sigmoid differs from torch's by up to two ulps,
  so ``silu(g) * u`` does; measured 1.6e-2, two ulps at |out| ~ 2.5).
  The expert products in bf16 equal XLA's bit for bit here.
* the combine: bit for bit against the reference's ``segment_sum`` lines
  jitted, in bf16 and float32 (XLA scatters the sorted entries one at a
  time, rounding after each add; the port sums them in that order).
* reduced models: forward logits, loss, decode logits and every cache
  (int8 ones dequantized), prefill: 2e-2, the dense family's bf16 bound
  (``tests/test_torch_serve.py``; measured: logits 7.8e-3, one bf16 ulp
  at |logit| in [1, 2); caches <= 5.0e-3); ``aux`` within 1e-4 under
  bf16 compute (measured 3.1e-5), 1e-6 under fp32 (measured 2.4e-7).
"""

import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.moe as R_moe
from repro.configs import get_config as r_get_config
from repro.configs.base import reduced as r_reduced
from repro.models.model import Model as RModel
from repro.quant.policy import policy_for as r_policy_for
from repro.serving.scheduler import ContinuousBatcher as RBatcher
from repro.serving.scheduler import Request as RRequest
from repro_torch.configs import get_config
from repro_torch.configs.base import reduced
from repro_torch.launch.serve import expert_bytes, serve
from repro_torch.models import moe as T_moe
from repro_torch.models.convert import (from_reference_cache,
                                        from_reference_params)
from repro_torch.models.model import EXPERT_NAMES, Model
from repro_torch.quant.policy import policy_for
from repro_torch.serving.scheduler import ContinuousBatcher
from test_torch_serve import _f32, _models, to_numpy_tree

TOL = 2e-2
FP32_TOL = 1e-5
MARGIN = 1e-5
ARCHS = ("moonshot-v1-16b-a3b", "phi3.5-moe-42b-a6.6b")
MOONSHOT = ARCHS[0]


def _gap(probs: np.ndarray, k: int) -> np.ndarray:
    """Per token, the k-th minus the (k+1)-th largest probability."""
    top = -np.sort(-probs, axis=-1)
    return top[:, k - 1] - top[:, k]


def _ffn_params(seed, d, E, ff):
    """Expert weights at scale d_in^-0.5 (outputs O(1)); a router at 0.1,
    so that the router logits spread ~0.8 (the reference's init at 0.02
    gives ~0.16 at d = 64): probabilities of a few percent and up, whose
    k-th / (k+1)-th gaps clear the margin (at a spread of ~4, a token's
    small probabilities sit ~1e-6 apart)."""
    rng = np.random.default_rng(seed)
    f = np.float32
    return {"router": (rng.standard_normal((d, E)) * 0.1).astype(f),
            "w_experts_gate": (rng.standard_normal((E, d, ff))
                               / np.sqrt(d)).astype(f),
            "w_experts_in": (rng.standard_normal((E, d, ff))
                             / np.sqrt(d)).astype(f),
            "w_experts_out": (rng.standard_normal((E, ff, d))
                              / np.sqrt(ff)).astype(f)}


def _ffn_cfg(**over):
    return reduced(get_config(MOONSHOT), **over)


# --------------------------------------------------------------- routing

@pytest.mark.parametrize("T,E,K", [(64, 4, 2), (96, 64, 6), (40, 16, 2)])
def test_topk_route_matches_reference(T, E, K):
    rng = np.random.default_rng(T + E)
    x = rng.standard_normal((T, 64)).astype(np.float32)
    w = (rng.standard_normal((64, E)) * 0.5).astype(np.float32)
    rg, re, ra = R_moe.topk_route(jnp.asarray(x), jnp.asarray(w), E, K)
    tg, te, ta = T_moe.topk_route(torch.from_numpy(x), torch.from_numpy(w),
                                  E, K)
    probs = np.asarray(jax.nn.softmax(jnp.asarray(x) @ jnp.asarray(w), -1))
    gap = _gap(probs, K)
    clear = gap > MARGIN
    print("smallest gap", float(gap.min()), "tokens under the margin",
          int((~clear).sum()))
    assert np.array_equal(te.numpy()[clear], np.asarray(re)[clear])
    np.testing.assert_allclose(tg.numpy()[clear], np.asarray(rg)[clear],
                               rtol=0, atol=1e-6)
    assert te.dtype == torch.int64 and tg.dtype == torch.float32
    assert abs(float(ta) - float(ra)) <= 1e-6 * abs(float(ra))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_topk_route_breaks_ties_to_the_lower_expert(dtype):
    """All-equal logits give experts 0..K-1 (jax.lax.top_k's order), and
    a tie among some experts goes to the lower index on both sides."""
    x = torch.ones((5, 8), dtype=dtype)
    got_g, got_e, _ = T_moe.topk_route(x, torch.zeros((8, 6)), 6, 3)
    assert got_e.tolist() == [[0, 1, 2]] * 5
    assert torch.equal(got_g, torch.full((5, 3), 1 / 3))
    _, want_e, _ = R_moe.topk_route(jnp.ones((5, 8)), jnp.zeros((8, 6)), 6, 3)
    assert np.asarray(want_e).tolist() == got_e.tolist()
    w = np.zeros((8, 6), np.float32)
    w[:, [1, 4, 5]] = 1.0            # three-way tie above the rest
    _, te, _ = T_moe.topk_route(torch.ones((2, 8)), torch.from_numpy(w), 6, 2)
    _, re, _ = R_moe.topk_route(jnp.ones((2, 8)), jnp.asarray(w), 6, 2)
    assert te.tolist() == np.asarray(re).tolist() == [[1, 4]] * 2


# --------------------------------------------------------------- moe_ffn

FFN_CASES = {
    # (b, s, E, K, capacity_factor): decode at T = 4 with C = 1 (drops),
    # prefill at the default factor, and the reference's 0.25 and 4.0
    "decode_C1": (4, 1, 64, 6, 1.25),
    "prefill": (2, 16, 4, 2, 1.25),
    "tight_0.25": (1, 64, 4, 2, 0.25),
    "ample_4.0": (2, 8, 4, 2, 4.0),
}


@pytest.mark.parametrize("mode", ["fp32", "bf16"])
@pytest.mark.parametrize("case", sorted(FFN_CASES))
def test_moe_ffn_matches_reference(case, mode):
    b, s, E, K, cf = FFN_CASES[case]
    cfg = _ffn_cfg(n_experts=E, top_k=K)
    d, ff = cfg.d_model, cfg.d_ff
    p = _ffn_params(E + s, d, E, ff)
    x = np.random.default_rng(s).standard_normal((b, s, d)).astype(np.float32)
    cap = T_moe.capacity(b * s, E, K, cf)
    assert cap == int(max(1, -(-b * s * K // E) * cf))
    if case == "decode_C1":
        assert cap == 1
    rdt = jnp.float32 if mode == "fp32" else jnp.bfloat16
    tdt = torch.float32 if mode == "fp32" else torch.bfloat16
    want, want_aux = jax.jit(lambda x, p: R_moe.moe_ffn(
        x, p, cfg, policy=r_policy_for(mode), train=False,
        capacity_factor=cf))(jnp.asarray(x, rdt),
                             {k: jnp.asarray(v) for k, v in p.items()})
    xt = torch.from_numpy(x).to(tdt)
    got, got_aux = T_moe.moe_ffn(xt, {k: torch.from_numpy(v)
                                      for k, v in p.items()}, cfg,
                                 policy=policy_for(mode), train=False,
                                 capacity_factor=cf)
    probs = torch.softmax(xt.reshape(-1, d).float()
                          @ torch.from_numpy(p["router"]), -1).numpy()
    gap = _gap(probs, K)
    assert gap.min() > MARGIN, f"a near-tie under the margin: {gap.min()}"
    _, experts, _ = T_moe.topk_route(xt.reshape(-1, d),
                                     torch.from_numpy(p["router"]), E, K)
    _, _, keep = T_moe.dispatch(experts, E, cap)
    assert got.dtype == tdt and tuple(got.shape) == (b, s, d)
    err = float(np.max(np.abs(_f32(got) - _f32(want))))
    print(case, mode, "C", cap, "dropped", int((~keep).sum()), "of",
          keep.numel(), "max|out|", float(np.abs(_f32(want)).max()),
          "err", err, "smallest gap", float(gap.min()))
    if case in ("decode_C1", "tight_0.25"):
        assert not bool(keep.all())
    if case == "ample_4.0":
        assert bool(keep.all())
    tol = FP32_TOL if mode == "fp32" else TOL
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=tol, atol=tol)
    assert abs(float(got_aux) - float(want_aux)) <= 1e-6


@pytest.mark.parametrize("mode", ["fp32", "bf16"])
def test_combine_equals_reference_segment_sum(mode):
    """The combine on the reference's own expert outputs, capacity,
    gates and dropped entries: bit for bit with the reference's lines
    (gather, mask, gate weighting, ``segment_sum``) jitted."""
    T, E, K, d = 48, 8, 3, 64
    rng = np.random.default_rng(11)
    experts = np.stack([rng.permutation(E)[:K] for _ in range(T)])
    gates = rng.uniform(0.05, 1.0, (T, K)).astype(np.float32)
    cap = T_moe.capacity(T, E, K, 0.5)
    rdt = jnp.float32 if mode == "fp32" else jnp.bfloat16
    out_buf = (rng.standard_normal((E, cap, d))
               * np.exp(rng.uniform(-3, 3, (E, cap, 1)))).astype(np.float32)

    def ref(out_buf, experts, gates):
        flat_expert = experts.reshape(-1)
        flat_token = jnp.repeat(jnp.arange(T), K)
        order = jnp.argsort(flat_expert)
        se, st, sg = flat_expert[order], flat_token[order], \
            gates.reshape(-1)[order]
        counts = jnp.bincount(se, length=E)
        starts = jnp.concatenate([jnp.zeros(1, counts.dtype),
                                  jnp.cumsum(counts)[:-1]])
        pos = jnp.arange(T * K) - starts[se]
        keep = pos < cap
        idx_e, idx_c = jnp.where(keep, se, 0), jnp.where(keep, pos, 0)
        gathered = jnp.where(keep[:, None], out_buf[idx_e, idx_c], 0.0)
        weighted = gathered * sg[:, None].astype(gathered.dtype)
        return jax.ops.segment_sum(weighted, st, num_segments=T)
    want = jax.jit(ref)(jnp.asarray(out_buf, rdt), jnp.asarray(experts),
                        jnp.asarray(gates))
    tdt = torch.float32 if mode == "fp32" else torch.bfloat16
    te = torch.from_numpy(experts)
    order, slot, keep = T_moe.dispatch(te, E, cap)
    assert not bool(keep.all())
    got = T_moe.combine(torch.from_numpy(out_buf).to(tdt), order, slot, keep,
                        torch.from_numpy(gates))
    assert np.array_equal(_f32(got), _f32(want))


def test_moe_ffn_refuses_quantized_training():
    """Once refused (ROADMAP A.8), quantized training of the experts now
    runs the reference's QAT ``edot``: the output and the gradients of
    the input and of every expert weight within the bf16 bound of
    ``moe_ffn`` (``TOL``; the gradients 3e-2 of their largest magnitude,
    measured <= 1.4e-2, the router's), against ``jax.value_and_grad`` of the reference
    on the same inputs."""
    b, s, E, K, cf = FFN_CASES["ample_4.0"]
    cfg = dataclasses.replace(_ffn_cfg(n_experts=E, top_k=K), quant="w8a8")
    d = cfg.d_model
    p = _ffn_params(E + s, d, E, cfg.d_ff)
    x = np.random.default_rng(s).standard_normal((b, s, d)) \
        .astype(np.float32)
    up = np.random.default_rng(7).standard_normal((b, s, d)) \
        .astype(np.float32)

    def ref(x, p):
        out, _ = R_moe.moe_ffn(x, p, cfg, policy=r_policy_for("w8a8"),
                               train=True, capacity_factor=cf)
        return jnp.sum(out.astype(jnp.float32) * up), out
    (_, want), want_g = jax.jit(jax.value_and_grad(
        ref, argnums=(0, 1), has_aux=True))(
        jnp.asarray(x), {k: jnp.asarray(v) for k, v in p.items()})
    xt = torch.from_numpy(x).requires_grad_(True)
    pt = {k: torch.from_numpy(v).requires_grad_(True) for k, v in p.items()}
    got, _ = T_moe.moe_ffn(xt, pt, cfg, policy=policy_for("w8a8"),
                           train=True, capacity_factor=cf)
    (got.float() * torch.from_numpy(up)).sum().backward()
    got = got.detach()
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=TOL, atol=TOL)
    grads = [("x", xt.grad, want_g[0])] + [
        (k, pt[k].grad, want_g[1][k]) for k in p]
    for name, g, w in grads:
        w = np.asarray(w)
        err = float(np.abs(g.numpy() - w).max() / np.abs(w).max())
        print("qat grad", name, err)
        assert err <= 3e-2, (name, err)
    plain, _ = T_moe.moe_ffn(xt.detach(), p={k: v.detach()
                                             for k, v in pt.items()},
                             cfg=cfg, policy=policy_for("w8a8"),
                             train=False, capacity_factor=cf)
    assert not torch.equal(plain, got)


# ------------------------------------------------------ reduced models

@contextlib.contextmanager
def _recorded_routes():
    """Record each ``topk_route`` call's experts on both sides and the
    port's k-th / (k+1)-th probability gap."""
    rec = {"ref": [], "port": [], "gap": []}
    real_r, real_t = R_moe.topk_route, T_moe.topk_route

    def ref(x, w, E, K):
        out = real_r(x, w, E, K)
        rec["ref"].append(np.asarray(out[1]))
        return out

    def port(x, w, E, K):
        out = real_t(x, w, E, K)
        probs = torch.softmax(x.float() @ w.float(), -1).numpy()
        rec["port"].append(out[1].numpy())
        rec["gap"].append(_gap(probs, K))
        return out
    R_moe.topk_route, T_moe.topk_route = ref, port
    try:
        yield rec
    finally:
        R_moe.topk_route, T_moe.topk_route = real_r, real_t


def _check_routes(rec):
    smallest = min(float(g.min()) for g in rec["gap"])
    assert smallest > MARGIN, f"a near-tie under the margin: {smallest}"
    if rec["ref"]:
        assert len(rec["ref"]) == len(rec["port"])
        for r, t in zip(rec["ref"], rec["port"]):
            assert np.array_equal(r, t)
    return smallest


MODEL_CASES = [(arch, mode, q) for arch in ARCHS
               for mode, q in (("w8a8", True), ("bf16", False),
                               ("fp32", False))]


@pytest.mark.parametrize("arch,mode,quantize", MODEL_CASES)
def test_forward_and_loss_match_reference(arch, mode, quantize):
    """s = 20 at batch 2 (T = 40, C = 25 of 4 experts): logits, aux
    (summed over the 2 layers) and ``Model.loss``; the reference run
    without jit so that its routing is recorded."""
    rmodel, rparams, tmodel, tparams = _models(arch, mode, quantize)
    tokens = np.random.default_rng(2).integers(0, tmodel.cfg.vocab, (2, 21))
    with _recorded_routes() as rec, jax.disable_jit():
        want, want_aux = rmodel.forward(rparams,
                                        jnp.asarray(tokens[:, :20], jnp.int32))
        got, got_aux = tmodel.forward(tparams,
                                      torch.from_numpy(tokens[:, :20]))
    smallest = _check_routes(rec)
    assert len(rec["port"]) == tmodel.cfg.n_layers
    tol = FP32_TOL if mode == "fp32" else TOL
    err = float(np.max(np.abs(_f32(got) - _f32(want))))
    aux_tol = 1e-6 if mode == "fp32" else 1e-4
    print(arch, mode, "logits", err, "aux", float(got_aux), float(want_aux),
          "smallest gap", smallest)
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=tol, atol=tol)
    assert got_aux.dtype == torch.float32
    assert abs(float(got_aux) - float(want_aux)) <= aux_tol
    batch = {"tokens": tokens[:, :20], "labels": tokens[:, 1:]}
    want_loss = jax.jit(lambda p, b: rmodel.loss(p, b, train=False))(
        rparams, {k: jnp.asarray(v, jnp.int32) for k, v in batch.items()})
    got_loss = tmodel.loss(tparams, {k: torch.from_numpy(v)
                                     for k, v in batch.items()}, train=False)
    assert abs(float(got_loss) - float(want_loss)) <= \
        tol * max(1.0, abs(float(want_loss)))


def _dequant(cache, scale):
    return _f32(cache) * _f32(scale)[..., None]


def _compare_caches(rcache, tcache, kv_quant, where):
    worst = {}
    assert set(rcache) == set(tcache)
    for name in ("k", "v"):
        if kv_quant:
            r = _dequant(rcache[name], rcache[f"{name}_scale"])
            t = _dequant(tcache[name], tcache[f"{name}_scale"])
        else:
            r, t = _f32(rcache[name]), _f32(tcache[name])
        worst[name] = float(np.max(np.abs(r - t)))
        np.testing.assert_allclose(t, r, rtol=TOL, atol=TOL,
                                   err_msg=f"{name} {where}")
    return worst


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("kv_quant", [False, True])
@pytest.mark.parametrize("per_slot", [False, True])
def test_teacher_forced_decode_matches_reference(arch, kv_quant, per_slot):
    """10 steps of ``decode_step`` at batch 3 (T = 3, C = 2 of 4 experts:
    some steps drop), W8A8 params, bf16 or int8 caches, positions shared
    or per slot (offsets 0, 2, 5): logits and every cache after each
    step, and the routing of every layer and step."""
    rmodel, rparams, tmodel, tparams = _models(arch, "w8a8", True)
    b, steps = 3, 10
    offs = np.array([0, 2, 5], np.int32) if per_slot \
        else np.zeros(b, np.int32)
    S = steps + int(offs.max())
    tokens = np.random.default_rng(1).integers(0, tmodel.cfg.vocab,
                                               (b, steps))
    rcache = rmodel.init_cache(b, S, kv_quant=kv_quant)
    tcache = tmodel.init_cache(b, S, kv_quant=kv_quant)
    worst = {"logits": 0.0}
    with _recorded_routes() as rec, jax.disable_jit():
        for i in range(steps):
            tok = tokens[:, i:i + 1]
            rpos = jnp.asarray(offs + i) if per_slot else jnp.int32(i)
            tpos = torch.from_numpy(offs + i) if per_slot else i
            rlog, rcache = rmodel.decode_step(
                rparams, rcache, jnp.asarray(tok, jnp.int32), rpos)
            tlog, tcache = tmodel.decode_step(tparams, tcache,
                                              torch.from_numpy(tok), tpos)
            worst["logits"] = max(worst["logits"], float(
                np.max(np.abs(_f32(rlog) - _f32(tlog)))))
            np.testing.assert_allclose(_f32(tlog), _f32(rlog), rtol=TOL,
                                       atol=TOL, err_msg=f"logits at {i}")
            for k, e in _compare_caches(rcache, tcache, kv_quant,
                                        f"at step {i}").items():
                worst[k] = max(worst.get(k, 0.0), e)
    smallest = _check_routes(rec)
    assert len(rec["port"]) == steps * tmodel.cfg.n_layers
    print(arch, kv_quant, per_slot, worst, "smallest gap", smallest)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_carried_cache_match_reference(arch):
    """``prefill`` over 12 prompt tokens at max_seq 16: logits and caches
    against the reference's; then the reference's int8 caches after 8
    steps, carried over by ``from_reference_cache``, and 4 more steps on
    both sides."""
    rmodel, rparams, tmodel, tparams = _models(arch, "w8a8", True)
    toks = np.random.default_rng(3).integers(0, tmodel.cfg.vocab, (2, 12))
    rlog, rcache = rmodel.prefill(rparams, jnp.asarray(toks, jnp.int32),
                                  max_seq=16)
    tlog, tcache = tmodel.prefill(tparams, torch.from_numpy(toks),
                                  max_seq=16)
    np.testing.assert_allclose(_f32(tlog), _f32(rlog), rtol=TOL, atol=TOL)
    _compare_caches(rcache, tcache, False, "after prefill")
    assert tcache["k"].dtype == torch.bfloat16
    decode = jax.jit(rmodel.decode_step)
    rcache = rmodel.init_cache(2, 12, kv_quant=True)
    for i in range(8):
        _, rcache = decode(rparams, rcache,
                           jnp.asarray(toks[:, i:i + 1], jnp.int32),
                           jnp.int32(i))
    tcache = from_reference_cache(tmodel, to_numpy_tree(rcache), device="cpu")
    for i in range(8, 12):
        rlog, rcache = decode(rparams, rcache,
                              jnp.asarray(toks[:, i:i + 1], jnp.int32),
                              jnp.int32(i))
        tlog, tcache = tmodel.decode_step(tparams, tcache,
                                          torch.from_numpy(toks[:, i:i + 1]),
                                          i)
        np.testing.assert_allclose(_f32(tlog), _f32(rlog), rtol=TOL,
                                   atol=TOL)
        _compare_caches(rcache, tcache, True, f"at step {i}")


# ------------------------------------------------------ params, storage

@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_experts_equal_float32_storage(arch):
    """``quantize_params`` stores the experts in bf16; the same model
    with the reference's float32 experts (cast at every use) gives the
    same forward and decode logits bit for bit."""
    _, _, tmodel, tparams = _models(arch, "w8a8", False)
    q = tmodel.quantize_params(tparams)
    f32 = dict(q, layers=[dict(lq, **{n: lf[n] for n in EXPERT_NAMES})
                          for lq, lf in zip(q["layers"], tparams["layers"])])
    for lq, lf in zip(q["layers"], f32["layers"]):
        assert lq["router"].dtype == torch.float32
        assert lq["wq"].data.dtype == torch.int8
        for n in EXPERT_NAMES:
            assert lq[n].dtype == torch.bfloat16
            assert lf[n].dtype == torch.float32
    toks = torch.from_numpy(np.random.default_rng(5).integers(
        0, tmodel.cfg.vocab, (2, 9)))
    assert torch.equal(tmodel.forward(q, toks)[0],
                       tmodel.forward(f32, toks)[0])
    ca, cb = tmodel.init_cache(2, 9), tmodel.init_cache(2, 9)
    for i in range(9):
        la, ca = tmodel.decode_step(q, ca, toks[:, i:i + 1], i)
        lb, cb = tmodel.decode_step(f32, cb, toks[:, i:i + 1], i)
        assert torch.equal(la, lb), i


@pytest.mark.parametrize("arch", ARCHS)
def test_init_draws_the_reference_layout(arch):
    """``init`` draws the reference's keys and shapes; ``init(quantize=
    True)`` equals ``quantize_params(init())``: int8 projections, the
    router float32, bf16 experts."""
    _, rparams, _, _ = _models(arch, "w8a8", False)
    want = to_numpy_tree(rparams)
    model = Model(reduced(get_config(arch)), device="cpu")
    params = model.init(torch.Generator("cpu").manual_seed(0))
    assert params.keys() == want.keys()
    for lp in params["layers"]:
        assert lp.keys() == want["layers"].keys()
        for name, t in lp.items():
            assert tuple(t.shape) == want["layers"][name].shape[1:], name
            assert t.dtype == torch.float32
    q = model.init(torch.Generator("cpu").manual_seed(0), quantize=True)
    again = model.quantize_params(params)
    for lq, la in zip(q["layers"], again["layers"]):
        assert torch.equal(lq["wo"].data, la["wo"].data)
        assert lq["router"].dtype == torch.float32
        for n in EXPERT_NAMES:
            assert lq[n].dtype == torch.bfloat16
            assert torch.equal(lq[n], la[n])


def test_full_configs_build_and_size():
    """Both full configs build on the CPU; one layer of moonshot at full
    width serves and prefills there; the experts' bytes that ``serve``
    refuses to draw in float32 at full width."""
    for arch in ARCHS:
        Model(get_config(arch), device="cpu")
    moon = get_config(MOONSHOT)
    assert expert_bytes(moon, False) == 48 * 3 * 64 * 2048 * 1408 * 4
    assert round(expert_bytes(moon, True) / 1e9, 2) == 53.15
    with pytest.raises(ValueError, match="--quant"):
        serve(MOONSHOT, smoke=False, device="cpu")
    cfg = dataclasses.replace(moon, n_layers=1, vocab=512)
    model = Model(cfg, device="cpu")
    params = model.init(torch.Generator("cpu").manual_seed(0), quantize=True)
    toks = torch.randint(0, cfg.vocab, (1, 3),
                         generator=torch.Generator("cpu").manual_seed(1))
    logits, caches = model.prefill(params, toks, max_seq=4)
    assert tuple(logits.shape) == (1, 3, cfg.vocab)
    assert bool(torch.isfinite(logits).all())
    assert tuple(caches["k"].shape) == (1, 1, 4, 16, 128)
    step, _ = model.decode_step(params, caches, toks[:, -1:], 3)
    assert bool(torch.isfinite(step).all())


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


def test_convert_refuses_trees_of_another_family():
    _, rparams, tmodel, _ = _models(MOONSHOT, "w8a8", True)
    tree = to_numpy_tree(rparams)
    dense = reduced(get_config("phi4-mini-3.8b"))
    with pytest.raises(ValueError, match="keys"):
        from_reference_params(dense, tree, device="cpu")
    layers = {k: v for k, v in tree["layers"].items() if k != "router"}
    with pytest.raises(ValueError, match="keys"):
        from_reference_params(tmodel.cfg, dict(tree, layers=layers),
                              device="cpu")


# ------------------------------------------------------------ ROADMAP C.9

def test_reference_moe_rows_share_capacity_and_batcher_feeds_free_slots():
    """ROADMAP C.9, pinned on the reference.  (1) At decode capacity C = 1
    (T = 4 tokens, 6 of 64 experts each), a row's output depends on the
    other rows: row 1 alone routes and computes, but when row 0 holds
    the same content it takes every one of row 1's experts first (the
    stable sort favours the lower token index), and row 1's output is
    zero.  (2) ``ContinuousBatcher.step`` passes every slot's
    ``next_tok`` to ``decode_step``, a free slot's stale one too.  If
    this starts failing, the reference changed: revisit the port's
    refusal."""
    cfg = r_reduced(r_get_config(MOONSHOT), n_experts=64, top_k=6)
    p = {k: jnp.asarray(v) for k, v in _ffn_params(3, 64, 64, 128).items()}
    x = np.random.default_rng(4).standard_normal((4, 1, 64)).astype(
        np.float32)
    ffn = jax.jit(lambda x: R_moe.moe_ffn(x, p, cfg, policy=r_policy_for(
        "bf16"), train=False)[0])
    apart = np.asarray(ffn(jnp.asarray(x, jnp.bfloat16)).astype(jnp.float32))
    same = x.copy()
    same[0] = x[1]
    shared = np.asarray(ffn(jnp.asarray(same, jnp.bfloat16))
                        .astype(jnp.float32))
    assert np.abs(apart[1]).max() > 0.1
    assert not shared[1].any()
    assert np.array_equal(shared[0], apart[1])

    rcfg = r_reduced(r_get_config(MOONSHOT))
    model = RModel(rcfg)
    params = model.init(jax.random.key(0))
    bat = RBatcher(model, params, n_slots=2, max_seq=16)
    fed = []
    real = bat._step

    def recording(params, caches, tokens, pos):
        fed.append((np.asarray(tokens)[:, 0].copy(), bat.state.copy()))
        return real(params, caches, tokens, pos)
    bat._step = recording
    short = RRequest(rid=0, prompt=[5, 6], max_new=2)
    long = RRequest(rid=1, prompt=[7, 8, 9], max_new=6)
    bat.submit(short)
    bat.submit(long)
    bat.run()
    stale = [toks[0] for toks, state in fed if state[0] == RBatcher.FREE]
    assert stale and all(t == short.generated[-1] for t in stale)


def test_port_batcher_refuses_moe():
    model = Model(reduced(get_config(MOONSHOT)), device="cpu")
    params = model.init(torch.Generator("cpu").manual_seed(0))
    with pytest.raises(NotImplementedError, match="ROADMAP C.9"):
        ContinuousBatcher(model, params, n_slots=2, max_seq=16)
    caches = model.init_cache(2, 8, kv_quant=True)
    assert caches["k"].dtype == torch.int8 and "k_scale" in caches
