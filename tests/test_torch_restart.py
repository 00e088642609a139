"""The port's tree checkpoints and restarting train loop against the
reference's, in one process on the same inputs:

* ``checkpoint.save`` / ``restore`` / ``restore_latest``: the four cases
  of the reference's ``tests/test_checkpoint.py``; a plain dict tree
  written by either package restores in the other, leaf for leaf; a
  train state (an ``AdamWState`` NamedTuple with a host int ``step``,
  per-layer lists) round-trips with its types, dtypes and devices;
* ``fault_tolerance.run_with_restarts`` on the reference's toy problem
  (``tests/test_runtime.py``): the loss lists, replayed steps included,
  and the restart counts equal the reference's; a restarted run equals
  an uninterrupted one bit for bit; a custom ``retryable``;
* ``launch.train.train(ckpt_dir=, fail_at=)`` on reduced mamba2 equals
  the uninterrupted run bit for bit, with and without compression;
* ROADMAP C.14, the reference's quirks the port keeps or refuses:
  (a) the losses of replayed steps stay in ``losses``; (b) the
  reference's ``restore`` cannot read back a bfloat16 leaf its ``save``
  wrote, so the port's ``save`` refuses one.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpoint as R_CK
from repro.runtime import fault_tolerance as R_FT
from repro_torch.checkpoint import checkpoint as T_CK
from repro_torch.configs import get_config
from repro_torch.configs.base import reduced
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.launch import train as T_train
from repro_torch.models.model import Model
from repro_torch.models.tree import tree_flatten, tree_map
from repro_torch.optim import adamw as TA
from repro_torch.parallel import compression as TC
from repro_torch.runtime import fault_tolerance as T_FT


def _tree(seed=0):
    rng = np.random.default_rng(seed)
    return {"a": torch.from_numpy(rng.standard_normal((4, 8))
                                  .astype(np.float32)),
            "nested": {"b": torch.arange(5, dtype=torch.int32),
                       "c": torch.tensor(3.5)}}


def _zeros_like(tree):
    return tree_map(torch.zeros_like, tree)


def _same(got, want):
    gl, gdef = tree_flatten(got)
    wl, wdef = tree_flatten(want)
    assert str(gdef) == str(wdef)
    for g, w in zip(gl, wl):
        assert type(g) is type(w)
        if isinstance(w, torch.Tensor):
            assert g.dtype == w.dtype and g.device == w.device
            assert torch.equal(g, w)
        else:
            assert g == w


# ------------------------------------------------- tree checkpoints

def test_roundtrip(tmp_path):
    t = _tree()
    T_CK.save(str(tmp_path), 3, t)
    _same(T_CK.restore(str(tmp_path), 3, _zeros_like(t)), t)


def test_latest_and_rotation(tmp_path):
    t = _tree()
    for s in range(6):
        T_CK.save(str(tmp_path), s, t, keep=3)
    assert sorted(os.listdir(tmp_path)) == [f"step_{s:08d}"
                                             for s in (3, 4, 5)]
    assert T_CK.latest_step(str(tmp_path)) == 5


def test_corruption_detected_and_skipped(tmp_path):
    t = _tree()
    T_CK.save(str(tmp_path), 1, t)
    T_CK.save(str(tmp_path), 2, t)
    with open(os.path.join(tmp_path, "step_00000002", "arrays.npz"),
              "r+b") as f:
        f.seek(10)
        f.write(b"\xde\xad\xbe\xef")
    assert T_CK.latest_step(str(tmp_path)) == 1      # falls back
    with pytest.raises(IOError):
        T_CK.restore(str(tmp_path), 2, t)
    step, out = T_CK.restore_latest(str(tmp_path), t)
    assert step == 1
    _same(out, t)


def test_restore_latest_empty(tmp_path):
    assert T_CK.restore_latest(str(tmp_path / "nope"), _tree()) == (None,
                                                                    None)


def test_checkpoint_layout_is_the_reference_s(tmp_path):
    """``step_<n>/arrays.npz`` with ``leaf_<i>`` in sorted-key order and a
    ``meta.json`` of ``step``, ``n_leaves``, ``sha256``, ``treedef``."""
    T_CK.save(str(tmp_path), 7, _tree())
    R_CK.save(str(tmp_path / "ref"), 7, jax.tree.map(
        lambda t: jnp.asarray(t.numpy()), _tree()))
    for root in (tmp_path, tmp_path / "ref"):
        with open(root / "step_00000007" / "meta.json") as f:
            meta = json.load(f)
        assert sorted(meta) == ["n_leaves", "sha256", "step", "treedef"]
        assert (meta["step"], meta["n_leaves"]) == (7, 3)
        with np.load(root / "step_00000007" / "arrays.npz") as z:
            assert sorted(z.files) == ["leaf_0", "leaf_1", "leaf_2"]
            assert z["leaf_0"].shape == (4, 8) and z["leaf_2"].shape == ()
    with open(tmp_path / "step_00000007" / "meta.json") as f:
        assert json.load(f)["treedef"] == \
            "{'a': *, 'nested': {'b': *, 'c': *}}"


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_tree_checkpoints_restore_across_packages(tmp_path, writer):
    t = _tree(1)
    r = jax.tree.map(lambda x: jnp.asarray(x.numpy()), t)
    if writer == "port":
        T_CK.save(str(tmp_path), 4, t)
        out = R_CK.restore(str(tmp_path), 4, jax.tree.map(jnp.zeros_like, r))
        for a, b in zip(jax.tree.leaves(out), tree_flatten(t)[0]):
            assert np.array_equal(np.asarray(a), b.numpy())
            assert np.asarray(a).dtype == b.numpy().dtype
    else:
        R_CK.save(str(tmp_path), 4, r)
        step, out = T_CK.restore_latest(str(tmp_path), _zeros_like(t))
        assert step == 4
        _same(out, t)


def _train_state(grad_compression=True):
    cfg = reduced(get_config("zamba2-1.2b"))
    params = Model(cfg, device="cpu").init(
        torch.Generator("cpu").manual_seed(0))
    opt = TA.init(params)
    opt = opt._replace(step=3, mu=tree_map(lambda p: p + 1, opt.mu))
    return {"params": params, "opt": opt,
            "err": TC.init_error_state(params) if grad_compression else {}}


@pytest.mark.parametrize("grad_compression", [True, False])
def test_train_state_roundtrips_types_and_devices(tmp_path,
                                                  grad_compression):
    """The NamedTuple, its host int ``step``, the per-layer lists, the
    hybrid's ``shared`` dict and an empty ``err`` come back as they went
    in, each leaf on ``like``'s device."""
    state = _train_state(grad_compression)
    T_CK.save(str(tmp_path), 0, state)
    like = _train_state(grad_compression)
    like["opt"] = like["opt"]._replace(step=0)
    out = T_CK.restore(str(tmp_path), 0, like)
    assert isinstance(out["opt"], TA.AdamWState)
    assert type(out["opt"].step) is int and out["opt"].step == 3
    assert isinstance(out["params"]["layers"], list)
    assert out["err"] == {} or isinstance(out["err"]["layers"], list)
    _same(out, state)
    with open(tmp_path / "step_00000000" / "meta.json") as f:
        meta = json.load(f)
    assert meta["n_leaves"] == len(tree_flatten(state)[0])
    assert "AdamWState(step=*, mu={" in meta["treedef"]


def test_restore_refuses_a_tree_of_another_size(tmp_path):
    T_CK.save(str(tmp_path), 0, _tree())
    with pytest.raises(KeyError):
        T_CK.restore(str(tmp_path), 0, {**_tree(), "z": torch.zeros(1)})
    with pytest.raises(ValueError, match="leaves for a tree of"):
        tree_flatten(_tree())[1].unflatten([0])


def test_c14b_reference_cannot_restore_bfloat16_and_port_refuses(tmp_path):
    """ROADMAP C.14 (b): the reference writes a bfloat16 leaf that its own
    ``restore`` cannot cast back; the port's ``save`` refuses the leaf and
    writes nothing."""
    R_CK.save(str(tmp_path / "ref"), 0, {"w": jnp.ones(3, jnp.bfloat16)})
    with pytest.raises(ValueError, match="No cast function"):
        R_CK.restore(str(tmp_path / "ref"), 0,
                     {"w": jnp.zeros(3, jnp.bfloat16)})
    with pytest.raises(TypeError, match="bfloat16.*ROADMAP C.14"):
        T_CK.save(str(tmp_path / "port"), 0,
                  {"w": torch.ones(3, dtype=torch.bfloat16)})
    assert not os.path.exists(tmp_path / "port")


# ----------------------------------------------- run_with_restarts

def _noise(step):
    return np.float32(0.01) * np.sin(np.float32(step))


def _ref_toy():
    """The reference test's tiny quadratic, its noise drawn in numpy and
    its loss summed left to right, so both packages do the same float32
    operations."""
    target = jnp.arange(4.0)

    def init_state():
        return {"w": jnp.zeros(4), "step": jnp.int32(0)}

    def train_step(state, batch):
        grad = 2 * (state["w"] - target) + batch["noise"]
        w = state["w"] - 0.1 * grad
        d = (w - target) ** 2
        return {"w": w, "step": state["step"] + 1}, \
            ((d[0] + d[1]) + d[2]) + d[3]

    return init_state, train_step, lambda s: {"noise": jnp.float32(
        _noise(s))}


def _port_toy():
    target = torch.arange(4.0)

    def init_state():
        return {"w": torch.zeros(4), "step": 0}

    def train_step(state, batch):
        grad = 2 * (state["w"] - target) + batch["noise"]
        w = state["w"] - 0.1 * grad
        d = (w - target) ** 2
        return {"w": w, "step": state["step"] + 1}, \
            ((d[0] + d[1]) + d[2]) + d[3]

    return init_state, train_step, lambda s: {"noise": torch.tensor(
        _noise(s))}


def _run(ft, toy, ckpt_dir, **kw):
    init_state, step_fn, data = toy()
    return ft.run_with_restarts(init_state=init_state, train_step=step_fn,
                                data_batch=data, total_steps=30,
                                ckpt_dir=str(ckpt_dir), ckpt_every=5, **kw)


@pytest.mark.parametrize("fail_at", [None, {12: 1}, {12: 1, 23: 2},
                                     {0: 2, 29: 1}])
def test_run_with_restarts_matches_reference(tmp_path, fail_at):
    ref = _run(R_FT, _ref_toy, tmp_path / "ref", fail_at=fail_at)
    got = _run(T_FT, _port_toy, tmp_path / "port", fail_at=fail_at)
    assert got.losses == ref.losses
    assert (got.restarts, got.final_step) == (ref.restarts, ref.final_step)
    assert got.restarts == sum((fail_at or {}).values())
    clean = _run(T_FT, _port_toy, tmp_path / "clean")
    assert dict(got.losses) == dict(clean.losses)     # bit for bit
    assert got.losses[-1] == clean.losses[-1] == (29, clean.losses[-1][1])


def test_c14a_replayed_steps_stay_in_losses(tmp_path):
    """ROADMAP C.14 (a): with ``ckpt_every=5, fail_at={12: 1}`` the
    restart replays steps 10 and 11 from step 9's checkpoint, and both
    packages keep their losses twice."""
    for ft, toy in ((R_FT, _ref_toy), (T_FT, _port_toy)):
        res = _run(ft, toy, tmp_path / ft.__name__, fail_at={12: 1})
        steps = [s for s, _ in res.losses]
        assert steps == list(range(12)) + list(range(10, 30))
        assert [s for s in set(steps) if steps.count(s) == 2] == [10, 11]


def test_run_with_restarts_custom_retryable(tmp_path):
    """The loop restarts from a checkpoint on a user-chosen exception
    class, not just ``InjectedFailure``; any other propagates."""
    init_state, step_fn, data = _port_toy()
    tripped = {"done": False}

    def step_with_io_error(state, batch):
        if state["step"] == 12 and not tripped["done"]:
            tripped["done"] = True
            raise OSError("nfs hiccup")
        return step_fn(state, batch)

    kw = dict(init_state=init_state, data_batch=data, total_steps=30,
              ckpt_every=5)
    clean = T_FT.run_with_restarts(train_step=step_fn,
                                   ckpt_dir=str(tmp_path / "clean"), **kw)
    faulty = T_FT.run_with_restarts(train_step=step_with_io_error,
                                    ckpt_dir=str(tmp_path / "faulty"),
                                    retryable=(OSError,), **kw)
    assert faulty.restarts == 1
    assert clean.losses[-1] == faulty.losses[-1]
    tripped["done"] = False
    with pytest.raises(OSError):                 # not retryable by default
        T_FT.run_with_restarts(train_step=step_with_io_error,
                               ckpt_dir=str(tmp_path / "default"), **kw)


def test_run_with_restarts_gives_up_past_max_restarts(tmp_path):
    with pytest.raises(T_FT.InjectedFailure):
        _run(T_FT, _port_toy, tmp_path, fail_at={3: 4}, max_restarts=3)


# --------------------------------------------------- train() knobs

TRAIN = dict(steps=6, batch=2, seq_len=16, log_every=100, device="cpu")


@pytest.mark.parametrize("grad_compression", [False, True])
def test_train_restarted_equals_uninterrupted(tmp_path, grad_compression,
                                              capsys):
    """A checkpointed ``train`` with two injected failures gives every
    step's loss of the plain loop bit for bit, the replayed steps again,
    and a final checkpoint equal leaf for leaf to the clean run's."""
    kw = dict(TRAIN, grad_compression=grad_compression)
    plain = T_train.train("mamba2-130m", **kw)
    clean = T_train.train("mamba2-130m", ckpt_dir=str(tmp_path / "a"),
                          ckpt_every=2, **kw)
    faulty = T_train.train("mamba2-130m", ckpt_dir=str(tmp_path / "b"),
                           ckpt_every=2, fail_at={3: 1, 5: 1}, **kw)
    assert "restarts=2 stragglers=" in capsys.readouterr().out
    assert clean == plain
    assert [s for s, _ in faulty] == [0, 1, 2, 2, 3, 4, 4, 5]
    assert dict(faulty) == dict(plain)
    like = _train_like(grad_compression)
    a = T_CK.restore_latest(str(tmp_path / "a"), like)
    b = T_CK.restore_latest(str(tmp_path / "b"), like)
    assert a[0] == b[0] == 5
    _same(b[1], a[1])
    assert a[1]["opt"].step == 6


def _train_like(grad_compression):
    cfg = reduced(get_config("mamba2-130m"))
    params = Model(cfg, device="cpu").init(
        torch.Generator("cpu").manual_seed(1))
    return {"params": params, "opt": TA.init(params),
            "err": TC.init_error_state(params) if grad_compression else {}}


def test_train_with_grad_compression_is_stable():
    losses = T_train.train("phi4-mini-3.8b", steps=6, seq_len=16, batch=2,
                           grad_compression=True, log_every=100,
                           device="cpu")
    assert losses[-1][1] < losses[0][1] * 1.5   # stable, no blowup
    assert all(np.isfinite(l) for _, l in losses)
    assert losses != T_train.train("phi4-mini-3.8b", steps=6, seq_len=16,
                                   batch=2, log_every=100, device="cpu")


def test_restored_state_continues_on_its_like_device(tmp_path):
    """The one-card part of the reference's ``reshard``: a checkpoint
    restores onto the device of ``like`` and training continues there;
    the next step equals the uninterrupted run's bit for bit."""
    cfg = reduced(get_config("mamba2-130m"))
    T_train.train("mamba2-130m", ckpt_dir=str(tmp_path), ckpt_every=2,
                  grad_compression=True, **TRAIN)
    plain = dict(T_train.train("mamba2-130m", grad_compression=True,
                               **TRAIN))
    like = _train_like(True)
    state = T_CK.restore(str(tmp_path), 3, like)
    assert all(t.device.type == "cpu"
               for t in tree_flatten(state)[0] if torch.is_tensor(t))
    ocfg = TA.AdamWConfig(lr=3e-3, total_steps=TRAIN["steps"],
                          warmup_steps=max(1, TRAIN["steps"] // 10))
    step = T_train.make_train_step(Model(cfg, device="cpu"), None, ocfg,
                                   grad_compression=True)
    data = SyntheticLM(DataConfig(cfg.vocab, TRAIN["seq_len"],
                                  TRAIN["batch"], seed=0))
    _, loss = step(state, data.batch(4, device="cpu"))
    assert float(loss) == plain[4]
