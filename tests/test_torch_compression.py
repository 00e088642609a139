"""The port's int8 gradient compression against the reference's
(:mod:`repro.parallel.compression`), and the compressed train step.

* ``compress_grads`` on gradients and error states converted from the
  reference's stacked trees (reduced mamba2, phi4-mini, zamba2): codes,
  scales and the new error state bit for bit against the reference's
  run op by op, one scale over all layers of each stacked key.  Under
  ``jax.jit`` the codes bit for bit, a scale within 1 ulp (XLA on the
  CPU divides by 127 as a multiplication by its reciprocal: 1 of
  zamba2's 18 scales moves) and the error state within one ulp of
  ``|g + e|`` (XLA fuses ``gf - q * scale`` into one rounding; the port
  rounds the product first, as the reference's source does).
* The reference's two error-feedback tests (``tests/test_runtime.py``)
  on the port.
* The compressed train step (``make_train_step(grad_compression=True)``)
  against the reference's for 3 steps on converted params, the losses at
  ``test_torch_train.BARS``.  At fp32 the step-0 gradients of the two
  packages, each compressed by its own package: a code differs only
  where the two gradients straddle a rounding boundary, by 1, and every
  other element's dequantized value and every scale at the fp32 bar.
  Under W8A8 QAT the two gradients are up to 2.5e-2 of a leaf's maximum
  apart (bf16), a few codes, so there the losses are held.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data.pipeline import DataConfig as RDataConfig
from repro.data.pipeline import SyntheticLM as RSyntheticLM
from repro.launch.mesh import make_host_mesh
from repro.launch.train import make_train_step as r_make_train_step
from repro.optim import adamw as RA
from repro.parallel import compression as RC
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.launch import train as T_train
from repro_torch.models.convert import from_reference_params
from repro_torch.models.tree import tree_map
from repro_torch.optim import adamw as TA
from repro_torch.parallel import compression as TC
from test_torch_serve import to_numpy_tree
from test_torch_train import BARS, _port_stacked, _ref_and_port, _ref_flat

R_COMPRESS = jax.jit(RC.compress_grads)     # the reference's train step jits it


def _random_like(rparams, seed, scale):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda p: jnp.asarray(
        rng.standard_normal(p.shape).astype(np.float32) * scale), rparams)


@pytest.mark.parametrize("arch", ["mamba2-130m", "phi4-mini-3.8b",
                                  "zamba2-1.2b"])
def test_compress_grads_matches_reference(arch):
    _, rparams, _, _, cfg = _ref_and_port(arch)
    rg = _random_like(rparams, 1, 1e-2)
    re = _random_like(rparams, 2, 1e-4)
    tg = from_reference_params(cfg, to_numpy_tree(rg), device="cpu")
    te = from_reference_params(cfg, to_numpy_tree(re), device="cpu")
    tq, ts, terr = TC.compress_grads(tg, te)
    assert all(q.dtype == torch.int8 for _, q, _ in TA.leaves(tq))
    got_q, got_s, got_e = (_port_stacked(t) for t in (tq, ts, terr))
    gf = {k: a + b for (k, a), b in zip(_ref_flat(rg).items(),
                                         _ref_flat(re).values())}
    # op by op, the reference's arithmetic: every leaf bit for bit, one
    # scale per leaf of the stacked tree in each layer's slot
    want_q, want_s, want_e = (_ref_flat(t)
                              for t in RC.compress_grads(rg, re))
    assert set(got_q) == set(want_q) == set(gf)
    for k in want_q:
        assert np.array_equal(got_q[k], want_q[k]), k
        assert np.all(got_s[k] == want_s[k]), k
        assert np.array_equal(got_e[k], want_e[k]), k
    stacked = [k for k in want_s if k.startswith("layers/")]
    assert stacked and all(got_s[k].shape == (cfg.n_layers,)
                           for k in stacked)
    # under jax.jit: the codes bit for bit; XLA rewrites ``m / 127`` as
    # ``m * (1 / 127)``, a scale 1 ulp off (zamba2's shared/ln2), and
    # fuses ``gf - q * scale``: one ulp of |g + e| plus what the scale's
    # ulp moves ``q * scale``
    jq, js, je = (_ref_flat(t) for t in R_COMPRESS(rg, re))
    moved = 0
    for k in jq:
        assert np.array_equal(got_q[k], jq[k]), k
        ds = np.abs(_stack_axes(got_s[k], jq[k]) - js[k])
        assert np.all(ds <= np.spacing(js[k])), k
        moved += bool(ds.any())
        bound = np.spacing(np.abs(gf[k])) + np.abs(jq[k]) * ds
        assert np.all(np.abs(got_e[k] - je[k]) <= bound), k
    assert moved <= 1


def _stack_axes(scale, codes):
    """A stacked key's (L,) scales broadcast against its (L, ...) codes."""
    return scale.reshape(scale.shape + (1,) * (codes.ndim - scale.ndim))


def test_stacked_scale_is_not_the_per_layer_one():
    """A per-layer walk would give each layer its own scale: on a stacked
    key the port takes the stack's maximum, which only the largest
    layer reaches."""
    rng = np.random.default_rng(5)
    layers = [{"w": torch.from_numpy(rng.standard_normal((6, 5))
                                     .astype(np.float32) * (l + 1))}
              for l in range(4)]
    grads = {"embed": torch.ones(3, 2), "layers": layers,
             "shared": {"v": torch.full((3,), 2.0)}}
    _, scales, _ = TC.compress_grads(grads, TC.init_error_state(grads))
    top = max(float(l["w"].abs().max()) for l in layers)
    want = torch.tensor(top, dtype=torch.float32) / torch.tensor(127.0)
    assert all(torch.equal(s["w"], want) for s in scales["layers"])
    assert not torch.equal(layers[0]["w"].abs().amax() / 127, want)
    assert float(scales["shared"]["v"]) == np.float32(2.0) / np.float32(127)


def test_grad_compression_error_feedback_unbiased():
    """Accumulated compressed grads converge to accumulated raw grads."""
    rng = np.random.default_rng(0)
    grads = {"w": torch.from_numpy(rng.standard_normal((16, 16))
                                   .astype(np.float32))}
    err = TC.init_error_state(grads)
    total_c = torch.zeros((16, 16))
    steps = 40
    for _ in range(steps):
        dq, err = TC.compress_roundtrip(grads, err)
        total_c = total_c + dq["w"]
    total_raw = grads["w"] * steps
    rel = float(torch.linalg.norm(total_c - total_raw)
                / torch.linalg.norm(total_raw))
    # error feedback keeps the *cumulative* bias bounded by one step's
    # quantization error -> relative error shrinks like 1/steps
    assert rel < 0.02, rel


def test_grad_compression_single_step_error_bounded():
    g = {"w": torch.linspace(-1, 1, 64).reshape(8, 8)}
    err = TC.init_error_state(g)
    dq, err2 = TC.compress_roundtrip(g, err)
    scale = float(g["w"].abs().max()) / 127
    assert float((dq["w"] - g["w"]).abs().max()) <= scale / 2 + 1e-6
    # residual == what was lost
    np.testing.assert_allclose(err2["w"].numpy(), (g["w"] - dq["w"]).numpy(),
                               atol=1e-6)


def _batches(cfg, step):
    dcfg = (cfg.vocab, 16, 2, 5)
    return (RSyntheticLM(RDataConfig(*dcfg)).batch(step),
            SyntheticLM(DataConfig(*dcfg)).batch(step, device="cpu"))


def _codes_agree_but_for_flips(rgrads, tparams, tmodel, tb):
    """The step-0 gradients of both packages, each compressed by its own
    package: returns the number of codes that differ (each by 1)."""
    leaves = tree_map(lambda p: p.detach().requires_grad_(True), tparams)
    tmodel.loss(leaves, tb).backward()
    tg = tree_map(lambda p: p.grad, leaves)
    rq, rs, _ = R_COMPRESS(rgrads, RC.init_error_state(rgrads))
    tq, ts, _ = TC.compress_grads(tg, TC.init_error_state(tg))
    want_q, want_s = _ref_flat(rq), _ref_flat(rs)
    got_q, got_s = _port_stacked(tq), _port_stacked(ts)
    bar = BARS["fp32"]["grad"]
    flips = 0
    for k in want_q:
        assert np.all(np.abs(got_s[k] - want_s[k]) <= bar * want_s[k]), k
        dq = np.abs(got_q[k] - want_q[k])
        assert dq.max() <= 1, (k, dq.max())
        flips += int(dq.sum())
        scale = want_s[k].reshape(-1)[0]
        top = 127 * scale
        kept = dq == 0
        deq = np.abs(got_q[k] * _stack_axes(got_s[k], got_q[k])
                     - want_q[k] * scale)
        assert np.all(deq[kept] <= bar * top), k
    return flips


@pytest.mark.parametrize("arch,mode", [("mamba2-130m", "fp32"),
                                       ("mamba2-130m", "w8a8"),
                                       ("phi4-mini-3.8b", "fp32")])
def test_compressed_train_step_matches_reference(arch, mode):
    over = dict(quant=mode)
    if arch == "mamba2-130m":
        over["ssm_chunk"] = 8
    rmodel, rparams, tmodel, tparams, cfg = _ref_and_port(arch, **over)
    bars = BARS[mode]
    if mode == "fp32":
        rb, tb = _batches(cfg, 0)
        _, rgrads = jax.value_and_grad(rmodel.loss)(rparams, rb)
        flips = _codes_agree_but_for_flips(rgrads, tparams, tmodel, tb)
        print(arch, mode, "code flips", flips)
    rc = RA.AdamWConfig(lr=3e-3, total_steps=3, warmup_steps=1)
    tc = TA.AdamWConfig(lr=3e-3, total_steps=3, warmup_steps=1)
    rstep = r_make_train_step(rmodel, make_host_mesh(), rc,
                              grad_compression=True)
    tstep = T_train.make_train_step(tmodel, None, tc,
                                    grad_compression=True)
    rs = {"params": rparams, "opt": RA.init(rparams),
          "err": RC.init_error_state(rparams)}
    ts = {"params": tparams, "opt": TA.init(tparams),
          "err": TC.init_error_state(tparams)}
    for step in range(3):
        rb, tb = _batches(cfg, step)
        rs, rloss = rstep(rs, rb)
        ts, tloss = tstep(ts, tb)
        rel = abs(float(tloss) - float(rloss)) / abs(float(rloss))
        print(arch, mode, "step", step, float(tloss), float(rloss), rel)
        assert rel <= bars["loss0" if step == 0 else "loss"]
    err = _port_stacked(ts["err"])
    assert set(err) == set(_ref_flat(rs["err"]))
    assert all(np.isfinite(e).all() for e in err.values())
    assert ts["opt"].step == int(rs["opt"].step) == 3
