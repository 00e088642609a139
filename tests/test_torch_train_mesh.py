"""Training across several ranks, with values: ``make_train_step`` and
``train()`` on ``DTensor`` state placed by the rule tables, held to the
port's unsharded step and to the reference's sharded step.

One module fixture spawns 4 gloo ranks once and, started together, one
subprocess runs the reference's ``make_train_step`` on
``make_host_mesh(model=2)`` over 4 forced host devices (``XLA_FLAGS`` in
its own environment only).  Reduced phi4-mini-3.8b (dense: TP products,
attention's plain route under grad), mamba2-130m (the chunked scan,
``ssm_chunk`` 8 as ``test_torch_train.py`` sets it) and
moonshot-v1-16b-a3b (EP: 4 experts over the 2 "model" ranks), each in
its config's W8A8 QAT policy and in ``fp32``, on the reference's
``Model.init`` params carried over by ``from_reference_params``.  The
batches are ``test_torch_train.py``'s ``SyntheticLM`` (sequence 16, seed
5) at batch 4, which the data axes of both meshes divide (its batch of 3
divides over neither, and the reference's EP refuses it).

The ranks run, on (2, 2), 3 steps of ``make_train_step`` (the step-0
gradients read where the step hands them to ``adamw.update``), and on
(4, 1) 3 steps of ``train()`` (its final checkpoint holds every leaf);
the same runs without a mesh run in this process.  The MoE's capacity and
aux loss are per data shard in the reference's ``shard_map`` body and in
the port's EP, so an MoE model's unsharded comparison runs its MoE
layers one data shard at a time (``_moe_by_data_shard``): the same
routing, unsharded.  Bars against the unsharded step:

* ``fp32``: the step-0 loss and each leaf's step-0 gradient within 1e-6
  of their scale (the loss, the leaf's largest magnitude); later losses
  1e-5 relative; every leaf after 3 steps within 1e-3 of its largest
  magnitude (Adam carries near-zero gradients' rounding into whole
  steps).  On (2, 2) a leaf whose own rounding floor is larger is held to
  that floor, printed beside it: how far the unsharded run moves when
  every param moves by half a float32 ulp (``_rounding_floors``).  Two
  leaves need it: mamba2's ``a_log`` gradient (2e-6 of its scale: its
  terms cancel) and moonshot's ``w_experts_out`` after 3 steps (1.3e-3:
  the unsharded run alone moves it as far);
* W8A8 QAT: ``test_torch_train.py``'s bars, loss 2.5e-4 at step 0 and
  1e-3 after, gradients 5e-2 of each leaf's largest magnitude (fake-quant
  codes flipped by a bf16 ulp, which the ``fp32`` witness shows apart).

Against the reference's sharded step: the losses at
``test_torch_train.py``'s bars for each policy.  On the placed step-0
gradients ``compress_grads`` is the unplaced one bit for bit (scales,
codes, outputs, residuals), and ``adamw.update`` bit for bit with the
clip off and within 2 float32 ulp with it on.  A 4-rank
``run_with_restarts`` (mamba2 W8A8, compression, ``ckpt_every=2``,
``fail_at={3: 1}``, 6 steps) equals the clean 4-rank run bit for bit
(losses, replays included, and the final checkpoint's bytes); that
checkpoint restored into an unplaced state here and stepped once equals
the ranks' 7th step within the W8A8 bars; a checkpoint written here
restores into a placed state on the ranks bit for bit.

The unit tests below need no spawn: a one-rank gloo group (always
released) and a ``fake_process_mesh((2, 2))`` under ``FakeTensorMode``.
"""

import dataclasses
import json
import os
import pathlib
import subprocess
import sys
import tempfile
import time

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.checkpoint import checkpoint as ckpt_lib
from repro_torch.configs import get_config
from repro_torch.configs.base import reduced
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.launch import train as T_train
from repro_torch.launch.mesh import (ensure_process_group,
                                     fake_process_mesh, make_host_mesh,
                                     release_process_group)
from repro_torch.models import moe
from repro_torch.models.model import Model
from repro_torch.models.tree import tree_flatten, tree_map
from repro_torch.optim import adamw
from repro_torch.parallel import compression
from repro_torch.parallel.sharding import (place, place_tree, placed_like,
                                           tree_shardings)

ROOT = pathlib.Path(__file__).resolve().parent.parent
WORLD = 4
ARCHS = ("phi4-mini-3.8b", "mamba2-130m", "moonshot-v1-16b-a3b")
#: "w8a8" is each of the three configs' own QAT policy
CASES = [(a, m) for a in ARCHS for m in ("w8a8", "fp32")]
MESHES = ("2x2", "4x1")
#: ``test_torch_train.py``'s SyntheticLM: sequence, batch, seed
SEQ, BATCH, DATA_SEED = 16, 4, 5
STEPS = 3
OCFG = dict(lr=3e-3, total_steps=STEPS, warmup_steps=1)
BARS = {"fp32": dict(loss0=1e-6, grad=1e-6, loss=1e-5, params=1e-3),
        "w8a8": dict(loss0=2.5e-4, grad=5e-2, loss=1e-3, params=None)}
REF_BARS = {"fp32": dict(loss0=1e-5, loss=1e-5),
            "w8a8": dict(loss0=2.5e-4, loss=1e-3)}
#: the restarted 4-rank run
RESTART = dict(arch="mamba2-130m", steps=6, ckpt_every=2, fail_at={3: 1})
#: a 4-rank run's seconds, fixture included, before it is stopped
DEADLINE_S = 420


def _over(arch: str, mode: str) -> dict:
    over = dict(quant=mode)
    if arch == "mamba2-130m":
        over["ssm_chunk"] = 8
    return over


def _cfg(arch: str, mode: str):
    return dataclasses.replace(reduced(get_config(arch)), **_over(arch,
                                                                  mode))


def _batch(cfg, step: int) -> dict:
    return SyntheticLM(DataConfig(cfg.vocab, SEQ, BATCH, DATA_SEED)).batch(
        step, device="cpu")


def _full(tree):
    """``tree`` with every placed leaf gathered whole (a collective on
    every rank)."""
    leaves, treedef = tree_flatten(tree)
    return treedef.unflatten([l.full_tensor() if hasattr(l, "full_tensor")
                              else l for l in leaves])


def _moe_by_data_shard(n_data: int):
    """``moe_ffn_ep`` as the sharded step runs it on ``n_data`` data
    shards, unsharded: each shard's tokens routed with its own capacity
    and aux, the aux averaged (the reference's ``shard_map`` body)."""
    def ep(x, p, cfg, *, policy, train, capacity_factor=1.25):
        outs, auxs = [], []
        for xc in x.chunk(n_data, 0):
            o, a = moe.moe_ffn(xc, p, cfg, policy=policy, train=train,
                               capacity_factor=capacity_factor)
            outs.append(o)
            auxs.append(a)
        return torch.cat(outs, 0), sum(auxs) / n_data
    return ep


class _Record:
    """``adamw.update`` (or, with ``compressed``, the round trip before
    it) patched to keep the first gradients it is handed (whole), as the
    train step hands them over."""

    def __init__(self, mp, compressed=False):
        self.grads = None
        module, name, pos = (compression, "compress_roundtrip", 0) \
            if compressed else (adamw, "update", 1)
        real = getattr(module, name)

        def record(*args):
            if self.grads is None:
                self.grads = _full(args[pos])
            return real(*args)
        mp.setattr(module, name, record)


def _steps(model, mesh, params, cfg, mp, *, compress=False):
    """3 steps of ``make_train_step`` from ``params``: the losses, the
    step-0 gradients and the final state, whole."""
    rec = _Record(mp)
    step = T_train.make_train_step(model, mesh, adamw.AdamWConfig(**OCFG),
                                   grad_compression=compress)
    state = {"params": params, "opt": adamw.init(params),
             "err": compression.init_error_state(params) if compress
             else {}}
    losses = []
    for s in range(STEPS):
        state, loss = step(state, _batch(cfg, s))
        assert not hasattr(loss, "placements") and loss.dim() == 0
        losses.append(float(loss))
    return {"losses": losses, "grads": rec.grads, "state": _full(state)}


def _train(arch, mode, ckpt_dir, mp):
    """3 steps of ``train()`` (its own seed-0 draw) checkpointed at the
    last: the losses, the step-0 gradients; the state is the checkpoint."""
    rec = _Record(mp)
    mp.setattr(T_train, "get_config",
               lambda a: dataclasses.replace(get_config(a),
                                             **_over(arch, mode)))
    losses = T_train.train(arch, steps=STEPS, batch=BATCH, seq_len=SEQ,
                           ckpt_dir=ckpt_dir, ckpt_every=STEPS,
                           log_every=100, device="cpu")
    return {"losses": [l for _, l in losses], "grads": rec.grads}


def _restart_state(cfg, compress=True):
    params = Model(cfg, device="cpu").init(
        torch.Generator("cpu").manual_seed(0))
    return {"params": params, "opt": adamw.init(params),
            "err": compression.init_error_state(params) if compress
            else {}}


def _restart_ocfg():
    return adamw.AdamWConfig(lr=3e-3, total_steps=RESTART["steps"],
                             warmup_steps=1)


def _restart_batch(cfg, step):
    return SyntheticLM(DataConfig(cfg.vocab, SEQ, BATCH, 0)).batch(
        step, device="cpu")


# ------------------------------------------------------- the 4 gloo ranks

def _rank_main(rank: int, world: int, init: str, out_dir: str) -> None:
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init}",
                            rank=rank, world_size=world)
    try:
        out = _rank_work(pathlib.Path(out_dir))
        if rank == 0:
            torch.save(out, os.path.join(out_dir, "ranks.pt"))
    finally:
        dist.barrier()
        dist.destroy_process_group()


def _rank_work(tmp: pathlib.Path) -> dict:
    import torch.distributed as dist
    from repro_torch.launch.mesh import all_reduce_sum
    params = torch.load(tmp / "params.pt", weights_only=False)
    out = {"2x2": {}, "4x1": {}, "comp": {}, "adamw": {}}
    mesh = make_host_mesh(model=2, device_type="cpu")
    for arch, mode in CASES:
        cfg = _cfg(arch, mode)
        model = Model(cfg, device="cpu")
        with pytest.MonkeyPatch.context() as mp:
            out["2x2"][arch, mode] = _steps(model, mesh,
                                            params[arch, mode], cfg, mp)
        grads = out["2x2"][arch, mode]["grads"]
        placed = tree_shardings(mesh, {"g": grads, "p": params[arch, mode]})
        g, p = placed["g"], placed["p"]
        err = tree_map(lambda t: t * 0.25, g)
        out["comp"][arch, mode] = _full(compression.compress_grads(g, err))
        st = adamw.init(p)
        res = {}
        for clip in (1e30, 1e-3):
            ocfg = adamw.AdamWConfig(**OCFG, clip_norm=clip)
            q, s, norms = p, st, []
            for _ in range(2):
                q, s, m = adamw.update(ocfg, g, s, q)
                norms.append(m["grad_norm"].full_tensor())
            res[clip] = {"state": _full({"params": q, "mu": s.mu,
                                         "nu": s.nu}), "norms": norms}
        out["adamw"][arch, mode] = res
    for arch, mode in CASES:
        with pytest.MonkeyPatch.context() as mp:
            out["4x1"][arch, mode] = _train(
                arch, mode, str(tmp / f"m41-{arch}-{mode}"), mp)
    # the restarted run against the clean one, then a 7th step
    r = RESTART
    kw = dict(steps=r["steps"], batch=BATCH, seq_len=SEQ,
              ckpt_every=r["ckpt_every"], grad_compression=True,
              log_every=100, device="cpu")
    out["restart"] = {
        "faulty": T_train.train(r["arch"], ckpt_dir=str(tmp / "faulty"),
                                fail_at=r["fail_at"], **kw),
        "clean": T_train.train(r["arch"], ckpt_dir=str(tmp / "clean"),
                               **kw)}
    cfg = reduced(get_config(r["arch"]))
    mesh41 = make_host_mesh(device_type="cpu")
    like = tree_shardings(mesh41, _restart_state(cfg))
    state = ckpt_lib.restore(str(tmp / "clean"), r["steps"] - 1, like)
    assert all(hasattr(l, "placements")
               for l in tree_flatten(state)[0] if torch.is_tensor(l))
    step = T_train.make_train_step(Model(cfg, device="cpu"), mesh41,
                                   _restart_ocfg(), grad_compression=True)
    with pytest.MonkeyPatch.context() as mp:
        rec = _Record(mp, compressed=True)
        state, loss = step(state, _restart_batch(cfg, r["steps"]))
    out["restart"]["seventh"] = {"loss": float(loss), "grads": rec.grads}
    # a checkpoint written by one process, restored placed
    out["from_one"] = _full(ckpt_lib.restore(str(tmp / "one"), 1, like))
    # a plain tensor's collective under autograd is still refused
    try:
        all_reduce_sum(torch.ones(2, requires_grad=True) * 2,
                       dist.group.WORLD)
        out["refusal"] = None
    except NotImplementedError as e:
        out["refusal"] = str(e)
    return out


REF_SCRIPT = r'''
import dataclasses, json, sys
import jax
assert jax.device_count() == 4, jax.device_count()
from repro.configs import get_config
from repro.configs.base import reduced
from repro.data.pipeline import DataConfig, SyntheticLM
from repro.launch.mesh import make_host_mesh
from repro.launch.train import make_train_step
from repro.models.model import Model
from repro.optim import adamw

cases, over, (seq, batch, seed), ocfg, steps = json.loads(sys.argv[1])
out = {}
for arch, mode in cases:
    cfg = dataclasses.replace(reduced(get_config(arch)),
                              **over[f"{arch}|{mode}"])
    model = Model(cfg)
    params = model.init(jax.random.key(0))
    mesh = make_host_mesh(model=2)
    assert tuple(mesh.devices.shape) == (2, 2)
    step = make_train_step(model, mesh, adamw.AdamWConfig(**ocfg))
    state = {"params": params, "opt": adamw.init(params), "err": {}}
    data = SyntheticLM(DataConfig(cfg.vocab, seq, batch, seed))
    losses = []
    for s in range(steps):
        state, loss = step(state, data.batch(s))
        losses.append(float(loss))
    out[f"{arch}|{mode}"] = losses

# C.16: the EP MoE's step-0 gradient on the (2, 2) mesh against the
# same forward unsharded, each data shard's tokens routed on their own
import jax.numpy as jnp
import repro.models.moe as RM
from repro.parallel.sharding import (activation_sharding,
                                     default_activation_rules)
arch = "moonshot-v1-16b-a3b"
cfg = dataclasses.replace(reduced(get_config(arch)), quant="fp32")
model = Model(cfg)
params = model.init(jax.random.key(0))
b0 = SyntheticLM(DataConfig(cfg.vocab, seq, batch, seed)).batch(0)
mesh = make_host_mesh(model=2)


def sharded(p, b):
    with activation_sharding(mesh, default_activation_rules(
            mesh, seq_sharded=False)):
        return model.loss(p, b)


def by_data_shard(x, p, cfg, *, policy, train, capacity_factor=1.25):
    parts = [RM.moe_ffn(xc, p, cfg, policy=policy, train=train,
                        capacity_factor=capacity_factor)
             for xc in jnp.split(x, 2, 0)]
    return (jnp.concatenate([o for o, _ in parts], 0),
            sum(a for _, a in parts) / 2)


ls, gs = jax.jit(jax.value_and_grad(sharded))(params, b0)
RM.moe_ffn_ep = by_data_shard
lu, gu = jax.jit(jax.value_and_grad(model.loss))(params, b0)
rel = {}
for (path, u), g in zip(jax.tree_util.tree_flatten_with_path(gu)[0],
                        jax.tree.leaves(gs)):
    rel[jax.tree_util.keystr(path)] = float(
        jnp.abs(g - u).max() / jnp.abs(u).max())
out["c16"] = {"loss": [float(ls), float(lu)], "rel": rel}
print(json.dumps(out))
'''


def _reference_params() -> dict:
    """Each case's params from the reference's ``Model.init`` (key 0),
    carried to the port."""
    import jax
    from repro.configs import get_config as r_get_config
    from repro.configs.base import reduced as r_reduced
    from repro.models.model import Model as RModel
    from repro_torch.models.convert import from_reference_params
    from test_torch_serve import to_numpy_tree
    out = {}
    for arch, mode in CASES:
        rcfg = dataclasses.replace(r_reduced(r_get_config(arch)),
                                   **_over(arch, mode))
        rparams = RModel(rcfg).init(jax.random.key(0))
        out[arch, mode] = from_reference_params(
            _cfg(arch, mode), to_numpy_tree(rparams), device="cpu")
    return out


def _rounding_floors(model, params, cfg, base, draws: int = 6) -> dict:
    """How far the unsharded run moves when every param moves by half a
    float32 ulp at random, the largest over ``draws`` draws, relative to
    each value's largest magnitude: each leaf's step-0 gradient
    (``"grads"``, by path) and each leaf after 3 steps (``"leaves"``, by
    index in ``tree_flatten``'s order).  ``base``: the run from
    ``params`` (:func:`_steps`)."""
    gen = torch.Generator().manual_seed(1)

    def nudge(t):
        sign = torch.where(torch.rand(t.shape, generator=gen) < 0.5, -1.0,
                           1.0)
        return t + t * sign * 2.0 ** -24

    def rel(a, b):
        return float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))
    grads = {p: 0.0 for p, _, _ in adamw.leaves(base["grads"])}
    leaves = [0.0] * len(tree_flatten(base["state"])[0])
    for _ in range(draws):
        with pytest.MonkeyPatch.context() as m:
            run = _steps(model, None, tree_map(nudge, params), cfg, m)
        for (path, g, _), (_, h, _) in zip(adamw.leaves(base["grads"]),
                                           adamw.leaves(run["grads"])):
            grads[path] = max(grads[path], rel(h, g))
        for i, (a, b) in enumerate(zip(tree_flatten(run["state"])[0],
                                       tree_flatten(base["state"])[0])):
            if torch.is_tensor(b) and b.is_floating_point():
                leaves[i] = max(leaves[i], rel(a, b))
    return {"grads": grads, "leaves": leaves}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The 4 gloo ranks (spawn) and the reference's sharded steps
    (subprocess), started together; the unsharded runs in this process
    meanwhile."""
    import torch.multiprocessing as mp
    t_start = time.monotonic()
    tmp = tmp_path_factory.mktemp("train_mesh")
    params = _reference_params()
    torch.save(params, tmp / "params.pt")
    # a one-process checkpoint for the ranks to restore placed: one
    # compressed step of the restart config
    cfg_r = reduced(get_config(RESTART["arch"]))
    one = T_train.make_train_step(Model(cfg_r, device="cpu"), None,
                                  _restart_ocfg(), grad_compression=True)
    one_state, _ = one(_restart_state(cfg_r), _restart_batch(cfg_r, 0))
    ckpt_lib.save(str(tmp / "one"), 1, one_state)
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin",
           "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=4"}
    args = [CASES, {f"{a}|{m}": _over(a, m) for a, m in CASES},
            (SEQ, BATCH, DATA_SEED), OCFG, STEPS]
    ref = subprocess.Popen(
        [sys.executable, "-c", REF_SCRIPT, json.dumps(args)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        cwd=str(ROOT))
    try:
        init = tempfile.mktemp(dir=tmp)
        ctx = mp.start_processes(_rank_main, args=(WORLD, init, str(tmp)),
                                 nprocs=WORLD, join=False,
                                 start_method="spawn")
        plain = {"2x2": {}, "4x1": {}, "floor": {}}
        for arch, mode in CASES:
            cfg = _cfg(arch, mode)
            model = Model(cfg, device="cpu")
            with pytest.MonkeyPatch.context() as m:
                m.setattr(moe, "moe_ffn_ep", _moe_by_data_shard(2))
                plain["2x2"][arch, mode] = _steps(model, None,
                                                  params[arch, mode], cfg, m)
                if mode == "fp32":
                    plain["floor"][arch, mode] = _rounding_floors(
                        model, params[arch, mode], cfg,
                        plain["2x2"][arch, mode])
            with pytest.MonkeyPatch.context() as m:
                m.setattr(moe, "moe_ffn_ep", _moe_by_data_shard(4))
                d = tmp / f"plain41-{arch}-{mode}"
                plain["4x1"][arch, mode] = _train(arch, mode, str(d), m)
        while not ctx.join(timeout=2):
            if time.monotonic() - t_start > DEADLINE_S:
                for p in ctx.processes:
                    p.kill()
                raise AssertionError(
                    f"the 4 ranks did not end in {DEADLINE_S} s")
        out, err = ref.communicate(
            timeout=max(10, DEADLINE_S - (time.monotonic() - t_start)))
        assert ref.returncode == 0, err[-3000:]
    finally:
        if ref.poll() is None:
            ref.kill()
    print(f"train_mesh fixture: {time.monotonic() - t_start:.1f} s")
    return {"tmp": tmp, "params": params, "plain": plain,
            "ranks": torch.load(tmp / "ranks.pt", weights_only=False),
            "ref": json.loads(out.strip().splitlines()[-1]),
            "one_state": one_state}


def _checkpoint_leaves(path: pathlib.Path) -> list:
    with np.load(path / "arrays.npz") as z:
        return [z[f"leaf_{i}"] for i in range(len(z.files))]


def _floors(ranks, mesh, case) -> dict:
    """The fp32 rounding floors (:func:`_rounding_floors`); they are
    measured on (2, 2)'s params and routing, none elsewhere."""
    none = {"grads": {}, "leaves": []}
    return ranks["plain"]["floor"].get(case, none) if mesh == "2x2" \
        else none


def _run(ranks, mesh, case):
    """The sharded and the unsharded run of a case on ``mesh``; for
    (4, 1) the states are ``train()``'s final checkpoints."""
    got, want = ranks["ranks"][mesh][case], ranks["plain"][mesh][case]
    if mesh == "4x1":
        arch, mode = case
        step = f"step_{STEPS - 1:08d}"
        got = {**got, "leaves": _checkpoint_leaves(
            ranks["tmp"] / f"m41-{arch}-{mode}" / step)}
        want = {**want, "leaves": _checkpoint_leaves(
            ranks["tmp"] / f"plain41-{arch}-{mode}" / step)}
    else:
        got = {**got, "leaves": [l.numpy() if torch.is_tensor(l) else l
                                 for l in tree_flatten(got["state"])[0]]}
        want = {**want, "leaves": [l.numpy() if torch.is_tensor(l) else l
                                   for l in tree_flatten(want["state"])[0]]}
    return got, want


@pytest.mark.parametrize("case", CASES, ids="|".join)
@pytest.mark.parametrize("mesh", MESHES)
def test_step0_loss_and_gradients_near_the_unsharded_step(ranks, mesh,
                                                          case):
    got, want = _run(ranks, mesh, case)
    bars = BARS[case[1]]
    rel = abs(got["losses"][0] - want["losses"][0]) / abs(want["losses"][0])
    print(mesh, case, "step-0 loss", got["losses"][0], want["losses"][0],
          rel)
    assert rel <= bars["loss0"]
    floor = _floors(ranks, mesh, case)["grads"]
    gl, wl = adamw.leaves(got["grads"]), adamw.leaves(want["grads"])
    assert [p for p, _, _ in gl] == [p for p, _, _ in wl]
    worst = (0.0, None, 0.0)
    for (path, g, _), (_, w, _) in zip(gl, wl):
        assert g.shape == w.shape and g.dtype == w.dtype, path
        scale = float(w.abs().max())
        err = float((g.double() - w.double()).abs().max()) / max(scale,
                                                                 1e-30)
        bar = max(bars["grad"], floor.get(path, 0.0))
        worst = max(worst, (err, path, floor.get(path, 0.0)))
        assert err <= bar, (path, err, bar)
    print(mesh, case, "worst gradient (rel, leaf, rounding floor)", worst)


@pytest.mark.parametrize("case", CASES, ids="|".join)
@pytest.mark.parametrize("mesh", MESHES)
def test_later_losses_and_leaves_near_the_unsharded_step(ranks, mesh, case):
    got, want = _run(ranks, mesh, case)
    bars = BARS[case[1]]
    for s in range(1, STEPS):
        rel = abs(got["losses"][s] - want["losses"][s]) \
            / abs(want["losses"][s])
        print(mesh, case, "step", s, got["losses"][s], want["losses"][s],
              rel)
        assert rel <= bars["loss"], s
    assert len(got["leaves"]) == len(want["leaves"])
    floor = _floors(ranks, mesh, case)["leaves"]
    worst = (0.0, None, 0.0)
    for i, (g, w) in enumerate(zip(got["leaves"], want["leaves"])):
        g, w = np.asarray(g), np.asarray(w)
        assert g.shape == w.shape and g.dtype == w.dtype, i
        if g.dtype.kind != "f":
            assert np.array_equal(g, w), i
            continue
        err = float(np.abs(g.astype(np.float64) - w).max()) \
            / max(float(np.abs(w).max()), 1e-30)
        f = floor[i] if i < len(floor) else 0.0
        worst = max(worst, (err, i, f))
        if bars["params"] is not None:
            bar = max(bars["params"], f)
            assert err <= bar, (i, err, bar)
        assert np.isfinite(g).all(), i
    print(mesh, case, "worst leaf after", STEPS,
          "steps (rel, index, rounding floor)", worst)


@pytest.mark.parametrize("case", CASES, ids="|".join)
def test_losses_within_the_reference_sharded_step(ranks, case):
    """The port on (2, 2) against the reference's ``make_train_step`` on
    ``make_host_mesh(model=2)``, 3 steps.  The reference's EP MoE trains
    on gradients that part from its own forward (C.16, pinned below), so
    moonshot is held at step 0, the forward both share; its later steps
    are printed."""
    got = ranks["ranks"]["2x2"][case]["losses"]
    want = ranks["ref"]["|".join(case)]
    assert len(got) == len(want) == STEPS
    bars = REF_BARS[case[1]]
    held = 1 if case[0] == "moonshot-v1-16b-a3b" else STEPS
    for s, (g, w) in enumerate(zip(got, want)):
        rel = abs(g - w) / abs(w)
        print(case, "step", s, "port", g, "reference", w, rel)
        if s < held:
            assert rel <= bars["loss0" if s == 0 else "loss"], s


def test_c16_reference_ep_gradients_part_from_its_own_forward(ranks):
    """C.16: the reference's ``moe_ffn_ep`` (``shard_map``) under
    ``jax.value_and_grad`` on a (2, 2) mesh: the loss equals the same
    forward run unsharded with each data shard routed on its own, but
    the gradients do not (the router's by more than a tenth of its
    scale).  The port's placed step holds that unsharded forward's
    gradients within 1e-6 (``test_step0_loss_and_gradients_...``)."""
    c16 = ranks["ref"]["c16"]
    ls, lu = c16["loss"]
    print("C.16 reference losses", ls, lu, "gradient parts", c16["rel"])
    assert abs(ls - lu) <= 1e-6 * abs(lu)
    router = [v for k, v in c16["rel"].items() if "router" in k]
    assert router and max(router) > 0.1
    port = ranks["ranks"]["2x2"]["moonshot-v1-16b-a3b", "fp32"]["grads"]
    plain = ranks["plain"]["2x2"]["moonshot-v1-16b-a3b", "fp32"]["grads"]
    for l in range(len(port["layers"])):
        a, b = port["layers"][l]["router"], plain["layers"][l]["router"]
        assert float((a - b).abs().max()) <= 1e-6 * float(b.abs().max())


def _bits(t) -> np.ndarray:
    t = t.detach().contiguous()
    return t.view(torch.int32 if t.element_size() == 4 else torch.int8) \
        .numpy()


@pytest.mark.parametrize("case", CASES, ids="|".join)
def test_compression_on_placed_gradients_is_bit_for_bit(ranks, case):
    """Scales, int8 codes and residuals of the placed round trip against
    the unplaced one on the same step-0 gradients (a maximum is exact);
    the decompressed outputs follow from codes and scales."""
    grads = ranks["ranks"]["2x2"][case]["grads"]
    err = tree_map(lambda t: t * 0.25, grads)
    want = compression.compress_grads(grads, err)
    got = ranks["ranks"]["comp"][case]
    for a, b in zip(tree_flatten(got)[0], tree_flatten(want)[0]):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert np.array_equal(_bits(a), _bits(b))
    outs = [compression.decompress_grads(t[0], t[1]) for t in (got, want)]
    for a, b in zip(*(tree_flatten(o)[0] for o in outs)):
        assert np.array_equal(_bits(a), _bits(b))


def _ulps(a: torch.Tensor, b: torch.Tensor) -> int:
    """The largest distance in float32 ulps between two float32 tensors
    (ordered as integers, signs folded)."""
    def key(t):
        i = t.contiguous().view(torch.int32).to(torch.int64)
        return torch.where(i < 0, -(i & 0x7FFFFFFF), i)
    return int((key(a) - key(b)).abs().max())


@pytest.mark.parametrize("clip", [1e30, 1e-3], ids=["unclipped", "clipped"])
@pytest.mark.parametrize("case", CASES, ids="|".join)
def test_adamw_on_placed_trees(ranks, case, clip, monkeypatch):
    """Two updates on the placed step-0 gradients and params.  Where
    clipping does not engage, bit for bit the unplaced ones.  Where it
    does, the global norm (a sum whose order the placement moves) within
    2 float32 ulp of the unplaced one, and given the placed norm every
    element bit for bit."""
    grads = ranks["ranks"]["2x2"][case]["grads"]
    got = ranks["ranks"]["adamw"][case][clip]
    ocfg = adamw.AdamWConfig(**OCFG, clip_norm=clip)

    def run():
        p, st, norms = ranks["params"][case], None, []
        st = adamw.init(p)
        for _ in range(2):
            p, st, m = adamw.update(ocfg, grads, st, p)
            norms.append(m["grad_norm"])
        return {"params": p, "mu": st.mu, "nu": st.nu}, norms
    want, norms = run()
    ulps = [_ulps(a, b) for a, b in zip(got["norms"], norms)]
    print(case, clip, "global norm: placed", got["norms"], "unplaced",
          norms, "ulps apart", ulps)
    assert max(ulps) <= 2
    if clip != 1e30:
        placed = iter(got["norms"])
        monkeypatch.setattr(adamw, "global_norm", lambda tree: next(placed))
        want, _ = run()
    for a, b in zip(tree_flatten(got["state"])[0], tree_flatten(want)[0]):
        assert a.dtype == b.dtype == torch.float32
        assert torch.equal(a, b)


def test_restarted_run_equals_the_clean_run(ranks):
    """Every loss (the replayed step 2 included) and the final
    checkpoint's bytes."""
    r = ranks["ranks"]["restart"]
    steps = [s for s, _ in r["faulty"]]
    assert steps == [0, 1, 2, 2, 3, 4, 5]
    clean = dict(r["clean"])
    assert [s for s, _ in r["clean"]] == list(range(RESTART["steps"]))
    assert all(l == clean[s] for s, l in r["faulty"])
    last = RESTART["steps"] - 1
    digests = [ckpt_lib.latest_step(str(ranks["tmp"] / d)) for d in
               ("faulty", "clean")]
    assert digests == [last, last]
    shas = [json.loads((ranks["tmp"] / d / f"step_{last:08d}" /
                        "meta.json").read_text())["sha256"]
            for d in ("faulty", "clean")]
    assert shas[0] == shas[1]


def test_four_rank_checkpoint_steps_on_one_process(ranks, monkeypatch):
    """The 4-rank run's final checkpoint restored into an unplaced state
    here, stepped once: the ranks' 7th step within the W8A8 bars (loss
    1e-3 after step 0, each leaf's gradient 5e-2 of its largest
    magnitude)."""
    cfg = reduced(get_config(RESTART["arch"]))
    like = _restart_state(cfg)
    state = ckpt_lib.restore(str(ranks["tmp"] / "clean"),
                             RESTART["steps"] - 1, like)
    assert not any(hasattr(l, "placements") for l in tree_flatten(state)[0])
    step = T_train.make_train_step(Model(cfg, device="cpu"), None,
                                   _restart_ocfg(), grad_compression=True)
    rec = _Record(monkeypatch, compressed=True)
    state, loss = step(state, _restart_batch(cfg, RESTART["steps"]))
    seventh = ranks["ranks"]["restart"]["seventh"]
    rel = abs(float(loss) - seventh["loss"]) / abs(float(loss))
    print("7th step loss, one process vs 4 ranks", float(loss),
          seventh["loss"], rel)
    assert rel <= BARS["w8a8"]["loss"]
    worst = 0.0
    for (path, a, _), (_, b, _) in zip(adamw.leaves(seventh["grads"]),
                                       adamw.leaves(rec.grads)):
        err = float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))
        worst = max(worst, err)
        assert err <= BARS["w8a8"]["grad"], path
    print("7th step gradients: worst leaf", worst)


def test_one_process_checkpoint_restores_placed(ranks):
    got = tree_flatten(ranks["ranks"]["from_one"])[0]
    want = tree_flatten(ranks["one_state"])[0]
    assert len(got) == len(want)
    for a, b in zip(got, want):
        if torch.is_tensor(b):
            assert a.dtype == b.dtype and torch.equal(a, b)
        else:
            assert a == b


def test_plain_collectives_under_grad_name_the_placed_route(ranks):
    msg = ranks["ranks"]["refusal"]
    assert msg is not None and "make_train_step" in msg
    assert "not ported" not in msg


# ------------------------------------------------------ no spawn needed

@pytest.fixture
def one_rank():
    ensure_process_group("cpu")
    try:
        yield make_host_mesh(device_type="cpu")
    finally:
        release_process_group()


def test_place_tree_keeps_every_global_shape():
    """A train state (params, AdamW moments, error feedback) of reduced
    moonshot on a fake 2 x 2 mesh: every leaf a ``DTensor`` of its
    global shape and dtype, the experts split over "model"."""
    cfg = reduced(get_config("moonshot-v1-16b-a3b"))
    with fake_process_mesh((2, 2), ("data", "model")) as mesh, \
            FakeTensorMode():
        state = _restart_state(cfg)
        placed = place_tree(mesh, state, lambda t, s: place(t, mesh, s))
        for a, b in zip(tree_flatten(placed)[0], tree_flatten(state)[0]):
            if torch.is_tensor(b):
                assert hasattr(a, "placements")
                assert a.shape == b.shape and a.dtype == b.dtype
            else:
                assert a == b
        w = placed["params"]["layers"][0]["w_experts_in"]
        assert w.to_local().shape[0] == cfg.n_experts // 2


def test_placed_like_turns_a_partial_gradient_into_its_params():
    from torch.distributed.tensor import DTensor, Partial, Shard
    with fake_process_mesh((2, 2), ("data", "model")) as mesh, \
            FakeTensorMode():
        p = DTensor.from_local(torch.empty(4, 8), mesh, [Shard(0), Shard(1)],
                               run_check=False)
        g = DTensor.from_local(torch.empty(8, 16), mesh,
                               [Partial(), Partial()], run_check=False)
        out = placed_like(g, p)
        assert list(out.placements) == list(p.placements)
        assert out.shape == p.shape and out.to_local().shape == (4, 8)


def test_placed_save_restore_on_one_rank(one_rank, tmp_path):
    """A placed state saves and restores on one rank bit for bit, into a
    placed ``like`` and into a plain one; the file is the one an
    unplaced save writes."""
    cfg = reduced(get_config("mamba2-130m"))
    state = _restart_state(cfg)
    state["err"] = tree_map(lambda t: t + 0.5, state["err"])
    placed = tree_shardings(one_rank, state)
    ckpt_lib.save(str(tmp_path / "placed"), 3, placed)
    ckpt_lib.save(str(tmp_path / "plain"), 3, state)
    metas = [json.loads((tmp_path / d / "step_00000003" / "meta.json")
                        .read_text()) for d in ("placed", "plain")]
    assert metas[0] == metas[1]
    for like in (placed, state):
        back = ckpt_lib.restore(str(tmp_path / "placed"), 3, like)
        for a, b, c in zip(tree_flatten(back)[0], tree_flatten(state)[0],
                           tree_flatten(like)[0]):
            if torch.is_tensor(b):
                assert hasattr(a, "placements") == hasattr(c, "placements")
                full = a.full_tensor() if hasattr(a, "full_tensor") else a
                assert torch.equal(full, b)
            else:
                assert a == b


def test_placed_step_on_a_one_rank_mesh_is_the_plain_step(one_rank):
    """Three compressed steps of reduced mamba2 and moonshot on a state
    placed on a one-rank mesh: losses and every leaf (params, ``mu``,
    ``nu``, ``err``) bit for bit the steps without a mesh, and the state
    that comes back placed."""
    for arch in ("mamba2-130m", "moonshot-v1-16b-a3b"):
        cfg = reduced(get_config(arch))
        model = Model(cfg, device="cpu")
        ocfg = adamw.AdamWConfig(**OCFG)
        runs = []
        for mesh in (None, one_rank):
            state = _restart_state(cfg)
            if mesh is not None:
                state = tree_shardings(mesh, state)
            step = T_train.make_train_step(model, mesh, ocfg,
                                           grad_compression=True)
            losses = []
            for s in range(STEPS):
                state, loss = step(state, _batch(cfg, s))
                losses.append(float(loss))
            runs.append((losses, state))
        (want, plain), (got, placed) = runs
        assert got == want, arch
        assert all(hasattr(l, "placements") for l in tree_flatten(placed)[0]
                   if torch.is_tensor(l))
        for a, b in zip(tree_flatten(_full(placed))[0],
                        tree_flatten(plain)[0]):
            assert torch.equal(a, b) if torch.is_tensor(b) else a == b
