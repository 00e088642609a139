"""The port's evaluation loss and synthetic data pipeline against the JAX
reference.

* ``SyntheticLM`` draws its tokens with numpy's ``default_rng`` exactly as
  the reference does: batches are equal bit for bit.
* ``cross_entropy`` on the same logits: 1e-6 relative (measured 2.0e-7
  from float32 logits, 0 from bf16 ones, which both upcast exactly).
* ``Model.loss(..., train=False)`` on a ``SyntheticLM`` batch, params
  carried over from the reference's ``Model.init``: 1e-5 relative under
  ``fp32`` (measured <= 1.8e-7) and 2.5e-4 under bf16 (measured <= 3.0e-5,
  zamba2; both sides compute the network in bf16 and round elementwise
  ops at other places), for reduced phi4-mini (dense), mamba2 and zamba2.
  At random init the loss is near ln V (0.13-0.16 below ln 256 at this
  size), so the bf16 bound (about 1.4e-3 absolute) is kept near its
  measured worst; labels rolled by one position move the loss by
  0.87-0.99.  The fp32 cases hold the loss's arithmetic; the bf16 forward
  is held logit by logit in ``test_torch_serve.py`` and
  ``test_torch_ssm.py``.  ``pytest -s`` prints each case's values.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as r_get_config
from repro.configs.base import reduced as r_reduced
from repro.data.pipeline import DataConfig as RDataConfig
from repro.data.pipeline import SyntheticLM as RSyntheticLM
from repro.models.common import cross_entropy as r_cross_entropy
from repro.models.model import Model as RModel
from repro_torch.configs import get_config
from repro_torch.configs.base import reduced
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.models.common import cross_entropy
from repro_torch.models.convert import from_reference_params
from repro_torch.models.model import Model
from test_torch_serve import to_numpy_tree

ARCHS = ("phi4-mini-3.8b", "mamba2-130m", "zamba2-1.2b")


@pytest.mark.parametrize("seed,step,shape", [
    (1234, 0, (256, 4, 8)), (1234, 3, (256, 4, 8)), (7, 0, (50, 2, 33)),
    (7, 11, (1000, 3, 5))])
def test_synthetic_lm_matches_reference_bit_for_bit(seed, step, shape):
    vocab, batch, seq = shape
    got = SyntheticLM(DataConfig(vocab, seq, batch, seed)).batch(
        step, device="cpu")
    want = RSyntheticLM(RDataConfig(vocab, seq, batch, seed)).batch(step)
    assert set(got) == {"tokens", "labels"}
    for k in got:
        assert got[k].dtype == torch.int32
        assert tuple(got[k].shape) == (batch, seq)
        assert np.array_equal(got[k].numpy(), np.asarray(want[k])), k
    assert torch.equal(got["tokens"][:, 1:], got["labels"][:, :-1])


def test_synthetic_lm_batches_and_device_guard():
    data = SyntheticLM(DataConfig(64, 6, 2, seed=3))
    it = data.batches(5, device="cpu")
    for want_step in (5, 6):
        step, b = next(it)
        assert step == want_step
        assert torch.equal(b["tokens"],
                           data.batch(want_step, "cpu")["tokens"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            data.batch(0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cross_entropy_matches_reference(dtype):
    rng = np.random.default_rng(0)
    logits = (rng.standard_normal((3, 7, 50)) * 4).astype(np.float32)
    labels = rng.integers(0, 50, (3, 7)).astype(np.int32)
    t = torch.from_numpy(logits).to(getattr(torch, dtype))
    j = jnp.asarray(logits).astype(getattr(jnp, dtype))
    for z in (1e-4, 0.0):
        got = float(cross_entropy(t, torch.from_numpy(labels), z_loss=z))
        want = float(r_cross_entropy(j, jnp.asarray(labels), z_loss=z))
        assert abs(got - want) <= 1e-6 * abs(want), (z, got, want)
        print(dtype, z, got, want)


CASES = [(a, m, tol) for a in ARCHS
         for m, tol in (("fp32", 1e-5), ("bf16", 2.5e-4))]


@pytest.mark.parametrize("arch,mode,tol", CASES)
def test_model_loss_matches_reference(arch, mode, tol):
    rcfg = dataclasses.replace(r_reduced(r_get_config(arch)), quant=mode,
                               ssm_chunk=8)
    tcfg = dataclasses.replace(reduced(get_config(arch)), quant=mode,
                               ssm_chunk=8)
    rmodel = RModel(rcfg)
    rparams = rmodel.init(jax.random.key(0))
    tmodel = Model(tcfg, device="cpu")
    tparams = from_reference_params(tcfg, to_numpy_tree(rparams),
                                    device="cpu")
    dcfg = (tcfg.vocab, 16, 3, 5)
    batch = SyntheticLM(DataConfig(*dcfg)).batch(0, device="cpu")
    rbatch = RSyntheticLM(RDataConfig(*dcfg)).batch(0)
    got = tmodel.loss(tparams, batch, train=False)
    want = float(rmodel.loss(rparams, rbatch, train=False))
    assert got.dtype == torch.float32 and got.dim() == 0
    rel = abs(float(got) - want) / abs(want)
    print(arch, mode, float(got), want, rel)
    assert rel <= tol


def test_loss_trains_only_unquantized():
    """Once refused (QAT was ROADMAP A.8): ``train=True`` under a quantized
    policy on float weights is the reference's QAT loss (fake-quantized
    projections and activations); under bf16 it equals ``train=False``.
    On reduced mamba2 with the reference's params: within the bf16 loss
    bar, 2.5e-4 (measured 1.1e-5; the gradients are held in
    ``test_torch_train.py``)."""
    cfg = dataclasses.replace(reduced(get_config("mamba2-130m")),
                              ssm_chunk=8)             # quant w8a8
    rcfg = dataclasses.replace(r_reduced(r_get_config("mamba2-130m")),
                               ssm_chunk=8)
    rmodel = RModel(rcfg)
    rparams = rmodel.init(jax.random.key(0))
    model = Model(cfg, device="cpu")
    params = from_reference_params(cfg, to_numpy_tree(rparams),
                                   device="cpu")
    dcfg = (cfg.vocab, 16, 3, 5)
    batch = SyntheticLM(DataConfig(*dcfg)).batch(0, device="cpu")
    rbatch = RSyntheticLM(RDataConfig(*dcfg)).batch(0)
    got = model.loss(params, batch)
    want = float(rmodel.loss(rparams, rbatch))
    rel = abs(float(got) - want) / abs(want)
    print("qat", float(got), want, rel)
    assert rel <= 2.5e-4
    assert not torch.equal(got, model.loss(params, batch, train=False))
    bf16 = Model(dataclasses.replace(cfg, quant="bf16"), device="cpu")
    assert torch.equal(bf16.loss(params, batch),
                       bf16.loss(params, batch, train=False))
