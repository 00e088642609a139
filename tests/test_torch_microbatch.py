"""Gradient-accumulation microbatching == full-batch gradients, on the
port's dry-run step.

The port of ``tests/test_microbatch.py``: the dry run's ``--microbatch``
path (``launch/dryrun.accumulate_grads``, which the train cell's step
runs) relies on the loss being a per-token mean, so the mean of the
micro-gradients is the full batch's gradient.  Held here on reduced
phi4-mini against the port's full batch with the reference's own bars,
and against the reference's accumulation (its ``lax.scan`` of
``value_and_grad``) on the same params, carried over by
``models/convert.py``, and the same tokens, with the float32 train
step's bars of ``tests/test_torch_train.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.launch.dryrun import accumulate_grads
from test_torch_train import _port_stacked, _ref_and_port, _ref_flat

B, S, MB = 8, 16, 4


def _ref_accumulated(rmodel, rparams, batch):
    """The reference test's accumulation: a scan over micro-slices."""
    def split(x):
        return x.reshape(MB, B // MB, *x.shape[1:])
    mbatch = jax.tree.map(split, batch)

    def acc_step(carry, micro):
        gsum, lsum = carry
        l, g = jax.value_and_grad(rmodel.loss)(rparams, micro)
        return (jax.tree.map(jnp.add, gsum, g), lsum + l), None

    g0 = jax.tree.map(lambda p: jnp.zeros(p.shape, jnp.float32), rparams)
    (gacc, lacc), _ = jax.lax.scan(acc_step, (g0, jnp.zeros(())), mbatch)
    return lacc / MB, jax.tree.map(lambda g: g / MB, gacc)


@pytest.fixture(scope="module")
def cell():
    rmodel, rparams, tmodel, tparams, cfg = _ref_and_port(
        "phi4-mini-3.8b", quant="fp32")
    toks = np.random.default_rng(1).integers(0, cfg.vocab, (B, S),
                                             dtype=np.int32)
    tbatch = {"tokens": torch.from_numpy(toks),
              "labels": torch.from_numpy(toks)}
    rbatch = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(toks)}
    return rmodel, rparams, tmodel, tparams, tbatch, rbatch


def test_microbatch_grads_match_full_batch(cell):
    """The reference test's bars: the loss within 2e-3, every gradient
    within 2e-2 of the largest (at least 1)."""
    _, _, tmodel, tparams, tbatch, _ = cell
    loss_full, g_full, _ = accumulate_grads(tmodel, tparams, tbatch, 1)
    loss_acc, g_acc, _ = accumulate_grads(tmodel, tparams, tbatch, MB)
    assert abs(float(loss_acc) - float(loss_full)) < 2e-3
    full, acc = _port_stacked(g_full), _port_stacked(g_acc)
    gmax = max(float(np.abs(g).max()) for g in full.values())
    errs = {k: float(np.abs(acc[k] - full[k]).max()) for k in full}
    assert max(errs.values()) < 2e-2 * max(gmax, 1.0), \
        sorted(errs.items(), key=lambda kv: kv[1])[-3:]


def test_microbatch_grads_match_reference_accumulation(cell):
    """The float32 train step's bars: the loss within 1e-5 relative, each
    gradient leaf within 1e-5 of its largest element."""
    rmodel, rparams, tmodel, tparams, tbatch, rbatch = cell
    rloss, rgrads = _ref_accumulated(rmodel, rparams, rbatch)
    tloss, tgrads, _ = accumulate_grads(tmodel, tparams, tbatch, MB)
    assert abs(float(tloss) - float(rloss)) <= 1e-5 * abs(float(rloss))
    want, got = _ref_flat(rgrads), _port_stacked(tgrads)
    assert set(want) == set(got)
    worst = max((np.abs(want[k] - got[k]).max() / np.abs(want[k]).max(), k)
                for k in want)
    assert worst[0] <= 1e-5, worst
