"""Placement across ranks on the CPU: the sharded sweep, expert
parallelism and elastic resharding on 4 ``torch.distributed`` ranks.

The reference's own multi-device tests run on 4 forced host devices
(``tests/test_mesh_sharding.py``); the port's counterpart is 4 gloo ranks
on the CPU.  One spawn of 4 ranks (:func:`_rank_main`, below) runs every
multi-rank check and writes what it computed; the test process compares.
Beside it, one subprocess runs the reference's ``moe_ffn_ep`` and
``survivable_mesh`` with ``XLA_FLAGS=--xla_force_host_platform_device_count=4``
set in its own environment only (the flag must precede the jax import and
must not leak into this process, ``tests/conftest.py``).  Both start
together and each has its own timeout.

* The sharded sweep: ``.single``, ``.many`` (uniform and mixed), the
  mixed-many kernel, the chunked stream and nsga2 / random searches on a
  4-rank ``DeviceMesh`` at n = 32 and n = 30 (divisible by 4 and not):
  bit for bit the unsharded exact path, which is bit for bit the
  reference's numpy path.
* The int path: the reference's cases of simulated shards, ``mesh=0``,
  and the card's refusal of an int.
* Elastic: ``reshard`` from (4, 1) to (2, 2) and onto
  ``survivable_mesh`` of 3 ranks, values bit for bit; the survivable
  meshes' shapes for 4, 3 and 2 ranks are the reference's.
* Expert parallelism: ``moe_ffn_ep`` on (1, 4) and (2, 2) against the
  reference's under 4 forced host devices, on one numpy-seeded layer of
  reduced moonshot carried over by ``models/convert.py``: within 1e-6 of
  the output scale in the float32 policy and one bf16 ulp of it in the
  bf16 policy.  On a 1 x 1 mesh (in this process) the port equals the
  reference's ``moe_ffn_ep`` within the MoE tests' tolerances.
"""

import dataclasses
import hashlib
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

from repro_torch.configs import get_config
from repro_torch.configs.base import reduced
from repro_torch.core import dse as TD
from repro_torch.core.accelerator import (AcceleratorConfig,
                                          configs_to_soa)
from repro_torch.core.dse_batch import _sweep_mixed_many
from repro_torch.core.pe import PEType, supported_modes
from repro_torch.core.workloads import get_workload

ROOT = pathlib.Path(__file__).resolve().parent.parent
WORLD = 4
SIZES = (32, 30)
WLS = ("vgg16", "resnet34")
TYPES = tuple(PEType)
SMALL_SPACE = [
    AcceleratorConfig(pe_type=t, pe_rows=r, pe_cols=c, glb_kb=g,
                      dram_bw_gbps=bw)
    for t in TYPES
    for (r, c, g, bw) in [(8, 8, 64, 6.4), (12, 14, 128, 12.8),
                          (32, 32, 512, 25.6)]]
EP_MESHES = ((1, 4), (2, 2))
EP_MODES = ("fp32", "bf16")
EP_SHAPE = (4, 8)                   # (batch, seq) of the MoE input
MOONSHOT = "moonshot-v1-16b-a3b"
SEARCH = dict(preset="many-quick", budget=48, seed=5)
MIXED_SEARCH = dict(preset="quick", budget=32, seed=3)


def _configs(n: int, seed: int = 7) -> list:
    rng = np.random.default_rng(seed)
    return [SMALL_SPACE[i] for i in rng.integers(0, len(SMALL_SPACE),
                                                  size=n)]


def _assigns(configs, wls, seed: int = 7) -> list:
    rng = np.random.default_rng(seed + 1)
    out = []
    for w in wls:
        a = np.empty((len(configs), len(w.layers)), dtype=np.int64)
        for i, c in enumerate(configs):
            modes = [TYPES.index(m) for m in supported_modes(c.pe_type)]
            a[i] = rng.choice(modes, size=len(w.layers))
        out.append(a)
    return out


def _ep_cfg(mode: str):
    return dataclasses.replace(reduced(get_config(MOONSHOT)), quant=mode)


def _ep_inputs(path: pathlib.Path) -> None:
    """A reference-shaped (stacked) numpy param tree of reduced moonshot
    and an input, seeded with numpy: experts at scale d_in^-0.5 and the
    router at 0.1, so that routing gaps clear the tie margin (as the MoE
    tests draw them)."""
    cfg = _ep_cfg("fp32")
    rng = np.random.default_rng(29)
    L, d, ff, E = cfg.n_layers, cfg.d_model, cfg.d_ff, cfg.n_experts
    hq, hkv = cfg.n_heads * cfg.head_dim, cfg.n_kv_heads * cfg.head_dim

    def normal(shape, scale):
        return (rng.standard_normal(shape) * scale).astype(np.float32)
    layers = {"ln1": np.ones((L, d), np.float32),
              "ln2": np.ones((L, d), np.float32),
              "wq": normal((L, d, hq), 0.02), "wk": normal((L, d, hkv), 0.02),
              "wv": normal((L, d, hkv), 0.02), "wo": normal((L, hq, d), 0.02),
              "router": normal((L, d, E), 0.1),
              "w_experts_gate": normal((L, E, d, ff), d ** -0.5),
              "w_experts_in": normal((L, E, d, ff), d ** -0.5),
              "w_experts_out": normal((L, E, ff, d), ff ** -0.5)}
    tree = {"embed": normal((cfg.vocab, d), 0.02),
            "final_norm": np.ones((d,), np.float32)}
    tree.update({f"layers/{k}": v for k, v in layers.items()})
    tree["x"] = rng.standard_normal(EP_SHAPE + (d,)).astype(np.float32)
    np.savez(path, **tree)


def _ep_tree(path) -> tuple[dict, np.ndarray]:
    z = np.load(path)
    tree = {"embed": z["embed"], "final_norm": z["final_norm"],
            "layers": {k.split("/", 1)[1]: z[k] for k in z.files
                       if k.startswith("layers/")}}
    return tree, z["x"]


def _digest(arrays: dict) -> str:
    h = hashlib.sha256()
    for k in sorted(arrays):
        a = np.ascontiguousarray(arrays[k])
        h.update(k.encode() + str(a.dtype).encode() + a.tobytes())
    return h.hexdigest()


# ---------------------------------------------------------------------------
# the 4-rank body
# ---------------------------------------------------------------------------

def _sweeps(mesh, device="cpu") -> dict:
    """Every sharded route's arrays, keyed ``{n}/{route}/{column}``."""
    from repro_torch.explore.search import random_search
    from repro_torch.explore.space import space_for_workload
    out = {}
    wls = tuple(get_workload(w) for w in WLS)
    for n in SIZES:
        cfgs = _configs(n)
        single = TD.run(TD.ExploreSpec.single(
            "vgg16", cfgs, outputs="sweep", use_cache=False, mesh=mesh),
            device=device)
        out.update({f"{n}/single/{k}": v for k, v in single.arrays.items()})
        many = TD.run(TD.ExploreSpec.many(
            WLS, configs=cfgs, outputs="aggregates", use_cache=False,
            mesh=mesh), device=device)
        for w, r in many.items():
            out.update({f"{n}/many/{w}/{k}": v for k, v in r.arrays.items()})
        agg = _sweep_mixed_many(wls, configs_to_soa(cfgs),
                                _assigns(cfgs, wls), use_cache=False,
                                device=device, mesh=mesh)
        out.update({f"{n}/mixed_many/{k}": v for k, v in agg.items()})
        stream = TD.run(TD.ExploreSpec.single(
            "vgg16", cfgs, chunk_size=8, mesh=mesh), device=device)
        out[f"{n}/chunked/n"] = np.array([stream.n_configs,
                                          stream.n_chunks])
        out.update({f"{n}/chunked/{k}": v
                    for k, v in stream.front_metrics.items()})
        out.update({f"{n}/chunked_soa/{k}": v
                    for k, v in stream.front_soa.items()})
        rs = random_search(space_for_workload(get_workload("vgg16")),
                           "vgg16", n, seed=n, chunk_size=8, device=device,
                           mesh=mesh)
        out[f"{n}/random/genomes"] = rs.genomes
        out[f"{n}/random/front"] = rs.front_objectives
    res = TD.run(TD.ExploreSpec.many(WLS, precision="mixed", mesh=mesh,
                                     **SEARCH), device=device)
    out["nsga2/genomes"] = res.genomes
    out["nsga2/front"] = res.front_objectives
    out["nsga2/mesh_shards"] = np.array(
        -1 if res.stats["mesh_shards"] is None else res.stats["mesh_shards"])
    mixed = TD.run(TD.ExploreSpec.mixed("vgg16", mesh=mesh, **MIXED_SEARCH),
                   device=device)
    out["mixed/genomes"] = mixed.genomes
    out["mixed/front"] = mixed.front_objectives
    return out


def _ep(mesh_shapes, npz) -> dict:
    from repro_torch.launch.mesh import device_mesh
    from repro_torch.models import moe
    from repro_torch.models.convert import from_reference_params
    from repro_torch.models.model import Model
    from repro_torch.parallel.sharding import (activation_sharding,
                                               default_activation_rules)
    tree, x = _ep_tree(npz)
    out = {}
    for shape in mesh_shapes:
        mesh = device_mesh("cpu", torch.arange(WORLD).reshape(shape),
                           ("data", "model"))
        for mode in EP_MODES:
            cfg = _ep_cfg(mode)
            lp = from_reference_params(cfg, tree, device="cpu")["layers"][0]
            policy = Model(cfg, device="cpu").policy
            xt = torch.from_numpy(x).to(policy.compute_dtype)
            with activation_sharding(mesh, default_activation_rules(
                    mesh, seq_sharded=False)):
                y, aux = moe.moe_ffn_ep(xt, lp, cfg, policy=policy,
                                        train=False)
            key = f"{shape[0]}x{shape[1]}/{mode}"
            out[f"{key}/out"] = y.float().numpy()
            out[f"{key}/aux"] = np.array(float(aux))
            # the local oracle: moe_ffn on each data slice alone
            parts = [moe.moe_ffn(xs, lp, cfg, policy=policy, train=False)
                     for xs in xt.chunk(shape[0])]
            out[f"{key}/slices"] = torch.cat(
                [p[0] for p in parts]).float().numpy()
            out[f"{key}/slices_aux"] = np.array(
                float(sum(p[1] for p in parts)) / shape[0])
    return out


def _elastic() -> dict:
    """Reshard a reduced phi4-mini train state (4, 1) -> (2, 2) ->
    survivable 3 ranks; each step's full tensors against the state."""
    from torch.distributed.tensor import DTensor
    from repro_torch.data.pipeline import shard_batch
    from repro_torch.launch.mesh import device_mesh
    from repro_torch.models.model import Model
    from repro_torch.models.tree import tree_flatten
    from repro_torch.optim import adamw
    from repro_torch.parallel.sharding import P
    from repro_torch.runtime.elastic import reshard, survivable_mesh
    cfg = reduced(get_config("phi4-mini-3.8b"))
    params = Model(cfg, device="cpu").init(
        torch.Generator("cpu").manual_seed(0))
    state = {"params": params, "opt": adamw.init(params)}
    leaves, _ = tree_flatten(state)
    out = {}

    def check(placed, mesh, name):
        got, _ = tree_flatten(placed)
        same = n = 0
        for a, b in zip(leaves, got):
            if not isinstance(a, torch.Tensor):
                continue
            assert isinstance(b, DTensor) and b.device_mesh == mesh
            full = b.full_tensor() if mesh.get_coordinate() is not None \
                else a
            same += int(torch.equal(full, a))
            n += 1
        out[f"{name}/equal"] = np.array([same, n])
        out[f"{name}/local_elems"] = np.array(sum(
            b.to_local().numel() for b in got if isinstance(b, DTensor)))

    m41 = device_mesh("cpu", torch.arange(4).reshape(4, 1), ("data", "model"))
    m22 = device_mesh("cpu", torch.arange(4).reshape(2, 2), ("data", "model"))
    s41 = reshard(state, m41)
    check(s41, m41, "4x1")
    s22 = reshard(s41, m22)
    check(s22, m22, "2x2")
    surv = survivable_mesh([0, 1, 2], device_type="cpu")
    out["survivor_shape"] = np.array(tuple(surv.shape))
    s3 = reshard(s22, surv)
    check(s3, surv, "survivable3")
    for k in (4, 3, 2):
        out[f"survivable/{k}"] = np.array(tuple(survivable_mesh(
            list(range(k)), device_type="cpu").shape))
    batch = {"tokens": torch.arange(16, dtype=torch.int32).reshape(4, 4)}
    placed = shard_batch(batch, m22, P("data", None))
    out["shard_batch/local"] = np.array(tuple(
        placed["tokens"].to_local().shape))
    out["shard_batch/equal"] = np.array(int(torch.equal(
        placed["tokens"].full_tensor(), batch["tokens"])))
    return out


def _grad_refused() -> bool:
    """A collective of several ranks under autograd raises (training
    across ranks is not ported)."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import all_gather_group, all_reduce_sum
    t = torch.ones(2, requires_grad=True) * 2
    refused = 0
    for fn in (all_reduce_sum, all_gather_group):
        try:
            fn(t, dist.group.WORLD)
        except NotImplementedError:
            refused += 1
    return refused == 2


def _rank_main(rank: int, world: int, init: str, out_dir: str,
               npz: str) -> None:
    """One of the 4 gloo ranks: every multi-rank check; rank 0 writes the
    arrays, every rank a digest of its own (identical on all ranks, as
    every rank gathers the whole result)."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_sweep_mesh
    dist.init_process_group("gloo", init_method=f"file://{init}",
                            rank=rank, world_size=world)
    try:
        out = _sweeps(make_sweep_mesh(device_type="cpu"))
        out.update(_ep(EP_MESHES, npz))
        out.update(_elastic())
        out["grad_refused"] = np.array(int(_grad_refused()))
        if rank == 0:
            np.savez(os.path.join(out_dir, "rank0.npz"), **out)
        shared = {k: v for k, v in out.items()
                  if not k.startswith(("survivable3/", "4x1/", "2x2/"))}
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump({"digest": _digest(shared),
                       "elastic": {k: out[k].tolist() for k in out
                                   if k.endswith(("/equal",
                                                  "/local_elems"))}}, f)
    finally:
        dist.barrier()
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the reference under 4 forced host devices
# ---------------------------------------------------------------------------

REF_SCRIPT = r'''
import dataclasses, json, sys
import numpy as np
assert "xla_force_host_platform_device_count=4" in __import__("os").environ[
    "XLA_FLAGS"]
import jax, jax.numpy as jnp
from repro.configs import get_config
from repro.configs.base import reduced
from repro.launch.mesh import compat_make_mesh
from repro.models import moe
from repro.parallel.sharding import (activation_sharding,
                                     default_activation_rules)
from repro.quant.policy import policy_for
from repro.runtime.elastic import survivable_mesh

npz, out_path = sys.argv[1], sys.argv[2]
z = np.load(npz)
lp = {k.split("/", 1)[1]: jnp.asarray(z[k][0]) for k in z.files
      if k.startswith("layers/")}
out = {"device_count": np.array(jax.device_count())}
for shape in json.loads(sys.argv[3]):
    mesh = compat_make_mesh(tuple(shape), ("data", "model"))
    for mode in json.loads(sys.argv[4]):
        cfg = dataclasses.replace(reduced(get_config("moonshot-v1-16b-a3b")),
                                  quant=mode)
        policy = policy_for(mode)
        x = jnp.asarray(z["x"], policy.compute_dtype)
        with activation_sharding(mesh, default_activation_rules(
                mesh, seq_sharded=False)):
            y, aux = jax.jit(lambda x, p: moe.moe_ffn_ep(
                x, p, cfg, policy=policy, train=False))(x, lp)
        key = f"{shape[0]}x{shape[1]}/{mode}"
        out[key + "/out"] = np.asarray(y, np.float32)
        out[key + "/aux"] = np.asarray(aux, np.float32)
for k in (4, 3, 2):
    out[f"survivable/{k}"] = np.array(
        survivable_mesh(jax.devices()[:k]).devices.shape)
np.savez(out_path, **out)
print("ok")
'''


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Start the reference subprocess and the 4-rank spawn together; the
    arrays of both and every rank's digest."""
    import torch.multiprocessing as mp
    tmp = tmp_path_factory.mktemp("mesh")
    npz = tmp / "ep_inputs.npz"
    _ep_inputs(npz)
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin",
           "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=4"}
    ref_out = tmp / "ref.npz"
    ref = subprocess.Popen(
        [sys.executable, "-c", REF_SCRIPT, str(npz), str(ref_out),
         json.dumps(EP_MESHES), json.dumps(EP_MODES)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        cwd=str(ROOT))
    try:
        init = tempfile.mktemp(dir=tmp)
        ctx = mp.start_processes(_rank_main,
                                 args=(WORLD, init, str(tmp), str(npz)),
                                 nprocs=WORLD, join=False,
                                 start_method="spawn")
        deadline = time.monotonic() + 300
        while not ctx.join(timeout=2):
            if time.monotonic() > deadline:
                for p in ctx.processes:
                    p.kill()
                raise AssertionError("the 4 ranks did not end in 300 s")
        _, err = ref.communicate(timeout=300)
        assert ref.returncode == 0, err[-3000:]
    finally:
        if ref.poll() is None:
            ref.kill()
    digests = [json.loads((tmp / f"rank{r}.json").read_text())
               for r in range(WORLD)]
    return (dict(np.load(tmp / "rank0.npz")), dict(np.load(ref_out)),
            digests)


@pytest.fixture(scope="module")
def unsharded():
    """The same routes on this process, without a mesh."""
    return _sweeps(None)


def test_every_rank_gathers_the_whole_result(ranks):
    _, _, digests = ranks
    assert len({d["digest"] for d in digests}) == 1


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("route", ["single", "many", "mixed_many",
                                   "chunked", "random"])
def test_sharded_sweep_bit_for_bit_unsharded(ranks, unsharded, n, route):
    """A 4-rank ``DeviceMesh`` (n = 30 pads 2 rows) gives the unsharded
    exact path's arrays bit for bit, shapes included."""
    got, _, _ = ranks
    keys = [k for k in unsharded if k.startswith(f"{n}/{route}")]
    assert keys
    for k in keys:
        assert got[k].shape == unsharded[k].shape, k
        assert np.array_equal(got[k], unsharded[k]), k


@pytest.mark.parametrize("search", ["nsga2", "mixed"])
def test_sharded_search_same_trajectory(ranks, unsharded, search):
    got, _, _ = ranks
    assert np.array_equal(got[f"{search}/genomes"],
                          unsharded[f"{search}/genomes"])
    assert np.array_equal(got[f"{search}/front"],
                          unsharded[f"{search}/front"])
    if search == "nsga2":
        assert int(got["nsga2/mesh_shards"]) == WORLD
        assert int(unsharded["nsga2/mesh_shards"]) == -1


@pytest.mark.parametrize("n", SIZES)
def test_unsharded_mixed_many_is_the_reference_numpy_path(unsharded, n):
    from repro.core.accelerator import AcceleratorConfig as RConfig
    from repro.core.accelerator import configs_to_soa as r_soa
    from repro.core.dse_batch import _sweep_mixed_many as r_many
    from repro.core.pe import PEType as RType
    from repro.core.workloads import get_workload as r_workload
    cfgs = _configs(n)
    rcfgs = [RConfig(pe_type=RType(c.pe_type.value), pe_rows=c.pe_rows,
                     pe_cols=c.pe_cols, glb_kb=c.glb_kb,
                     dram_bw_gbps=c.dram_bw_gbps) for c in cfgs]
    wls = tuple(get_workload(w) for w in WLS)
    want = r_many(tuple(r_workload(w) for w in WLS), r_soa(rcfgs),
                  _assigns(cfgs, wls), backend="numpy", use_cache=False)
    for k, v in want.items():
        assert np.array_equal(unsharded[f"{n}/mixed_many/{k}"], v), k


# ---------------------------------------------------------------- int path

def _batch(n: int):
    cfgs = _configs(n)
    wls = tuple(get_workload(w) for w in WLS)
    return wls, configs_to_soa(cfgs), _assigns(cfgs, wls)


@pytest.mark.parametrize("n,shards", [(24, 4),   # divisible
                                      (29, 4),   # non-divisible
                                      (3, 8)])   # more shards than rows
def test_int_shards_bit_identical(n, shards):
    """The reference's simulated shards (``tests/test_mesh_sharding.py``):
    contiguous splits evaluated alone, concatenated, bit for bit."""
    wls, soa, assigns = _batch(n)
    un = _sweep_mixed_many(wls, soa, assigns, device="cpu", use_cache=False)
    sh = _sweep_mixed_many(wls, soa, assigns, device="cpu", use_cache=False,
                           mesh=shards)
    assert set(un) == set(sh)
    for k in un:
        assert np.array_equal(un[k], sh[k]), k
    single = TD.run(TD.ExploreSpec.single("vgg16", _configs(n),
                                          outputs="sweep", use_cache=False,
                                          mesh=shards), device="cpu")
    plain = TD.run(TD.ExploreSpec.single("vgg16", _configs(n),
                                         outputs="sweep", use_cache=False),
                   device="cpu")
    for k, v in plain.arrays.items():
        assert single.arrays[k].shape == v.shape
        assert np.array_equal(single.arrays[k], v), k


def test_int_mesh_threads_through_search():
    base = TD.run(TD.ExploreSpec.many(WLS, precision="mixed", **SEARCH),
                  device="cpu")
    sharded = TD.run(TD.ExploreSpec.many(WLS, precision="mixed", mesh=3,
                                         **SEARCH), device="cpu")
    assert np.array_equal(base.genomes, sharded.genomes)
    assert np.array_equal(base.front_objectives, sharded.front_objectives)
    assert sharded.stats["mesh_shards"] == 3
    assert base.stats["mesh_shards"] is None


def test_invalid_mesh_args():
    wls, soa, assigns = _batch(6)
    with pytest.raises(ValueError, match="shard count"):
        _sweep_mixed_many(wls, soa, assigns, device="cpu", use_cache=False,
                          mesh=0)
    with pytest.raises(TypeError, match="DeviceMesh"):
        _sweep_mixed_many(wls, soa, assigns, device="cpu", use_cache=False,
                          mesh="configs")


def test_card_refuses_an_int_mesh(monkeypatch):
    """An int shard count on the card raises and names
    ``make_sweep_mesh`` (a stand-in ``cuda`` device: the refusal comes
    before anything reaches CUDA)."""
    from repro_torch.core import dse_batch
    monkeypatch.setattr(dse_batch, "resolve_device",
                        lambda device="cuda": torch.device("cuda", 0))
    wls, soa, assigns = _batch(6)
    with pytest.raises(ValueError, match="make_sweep_mesh"):
        _sweep_mixed_many(wls, soa, assigns, device="cuda", mesh=2)
    with pytest.raises(ValueError, match="make_sweep_mesh"):
        dse_batch._sweep_chunked(get_workload("vgg16"), _configs(6),
                                 device="cuda", mesh=2)


def test_meshes_refuse_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    from repro_torch.launch import mesh
    for make in (mesh.make_sweep_mesh, mesh.make_host_mesh):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make()
    assert not torch.distributed.is_initialized()


def test_production_meshes():
    from repro_torch.launch.mesh import make_production_mesh, mesh_shards
    pod, multi = make_production_mesh(), make_production_mesh(multi_pod=True)
    assert (pod.shape, pod.mesh_dim_names) == ((16, 16), ("data", "model"))
    assert (multi.shape, multi.mesh_dim_names) \
        == ((2, 16, 16), ("pod", "data", "model"))
    assert mesh_shards(multi) == 512 and mesh_shards(None) == 1
    assert mesh_shards(3) == 3


# ---------------------------------------------------------------- elastic

def test_reshard_keeps_every_value(ranks):
    _, _, digests = ranks
    for d in digests:
        e = d["elastic"]
        for name in ("4x1", "2x2", "survivable3"):
            same, n = e[f"{name}/equal"]
            assert n > 0 and same == n, (name, same, n)
    # the state's elements spread over the ranks: fewer than whole on each
    locs = [d["elastic"]["2x2/local_elems"] for d in digests]
    whole = digests[0]["elastic"]["4x1/local_elems"]
    assert max(locs) < 4 * whole


def test_collectives_under_grad_refused_across_ranks(ranks):
    got, _, _ = ranks
    assert int(got["grad_refused"]) == 1


def test_survivable_mesh_shapes_are_the_reference(ranks):
    got, ref, _ = ranks
    for k in (4, 3, 2):
        assert tuple(got[f"survivable/{k}"]) \
            == tuple(ref[f"survivable/{k}"]), k
    assert tuple(got["survivor_shape"]) == (3, 1)
    assert tuple(got["shard_batch/local"]) == (2, 4)
    assert int(got["shard_batch/equal"]) == 1


# ----------------------------------------------------- expert parallelism

def _bf16_ulp(scale: float) -> float:
    return 2.0 ** (np.floor(np.log2(scale)) - 7)


@pytest.mark.parametrize("mode", EP_MODES)
@pytest.mark.parametrize("shape", EP_MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_moe_ffn_ep_matches_reference_on_four_ranks(ranks, shape, mode):
    """Against the reference's ``moe_ffn_ep`` under 4 forced host
    devices: the float32 policy within 1e-6 of the output scale, the bf16
    policy within one bf16 ulp of it; ``aux`` (the data axes' mean)
    within 1e-6.  Each data slice routes on its own capacity, so the port
    also equals ``moe_ffn`` applied to each slice alone (bit for bit in
    these draws)."""
    got, ref, _ = ranks
    assert int(ref["device_count"]) == 4
    key = f"{shape[0]}x{shape[1]}/{mode}"
    y, want = got[f"{key}/out"], ref[f"{key}/out"]
    scale = float(np.abs(want).max())
    tol = 1e-6 * scale if mode == "fp32" else _bf16_ulp(scale)
    err = float(np.abs(y - want).max())
    assert err <= tol, (err, tol)
    assert abs(float(got[f"{key}/aux"]) - float(ref[f"{key}/aux"])) <= 1e-6
    assert np.array_equal(y, got[f"{key}/slices"])
    assert abs(float(got[f"{key}/aux"])
               - float(got[f"{key}/slices_aux"])) <= 1e-6


@pytest.fixture
def one_rank_mesh():
    from repro_torch.launch.mesh import (ensure_process_group,
                                         make_host_mesh,
                                         release_process_group)
    ensure_process_group("cpu")
    try:
        yield make_host_mesh(device_type="cpu")
    finally:
        release_process_group()


@pytest.mark.parametrize("mode", EP_MODES)
def test_moe_ffn_ep_one_by_one_mesh(one_rank_mesh, mode, tmp_path):
    """On a 1 x 1 mesh the port's ``moe_ffn_ep`` equals the reference's
    (a one-device ``shard_map``) within the MoE tests' tolerances, and its
    own ``moe_ffn`` bit for bit."""
    import jax
    import jax.numpy as jnp
    import repro.models.moe as R_moe
    from repro.launch.mesh import compat_make_mesh
    from repro.parallel.sharding import activation_sharding as r_act
    from repro.parallel.sharding import default_activation_rules as r_rules
    from repro.quant.policy import policy_for as r_policy_for
    from repro_torch.models import moe
    from repro_torch.models.convert import from_reference_params
    from repro_torch.parallel.sharding import (activation_sharding,
                                               default_activation_rules)
    from repro_torch.quant.policy import policy_for
    npz = tmp_path / "ep.npz"
    _ep_inputs(npz)
    tree, x = _ep_tree(npz)
    cfg = _ep_cfg(mode)
    lp = from_reference_params(cfg, tree, device="cpu")["layers"][0]
    policy = policy_for(mode)
    xt = torch.from_numpy(x).to(policy.compute_dtype)
    with activation_sharding(one_rank_mesh, default_activation_rules(
            one_rank_mesh, seq_sharded=False)):
        got, got_aux = moe.moe_ffn_ep(xt, lp, cfg, policy=policy,
                                      train=False)
    plain, plain_aux = moe.moe_ffn(xt, lp, cfg, policy=policy, train=False)
    assert torch.equal(got, plain) and float(got_aux) == float(plain_aux)
    rmesh = compat_make_mesh((1, 1), ("data", "model"))
    rp = {k: jnp.asarray(v[0]) for k, v in tree["layers"].items()}
    rpol = r_policy_for(mode)
    with r_act(rmesh, r_rules(rmesh, seq_sharded=False)):
        want, want_aux = jax.jit(lambda x, p: R_moe.moe_ffn_ep(
            x, p, cfg, policy=rpol, train=False))(
                jnp.asarray(x, rpol.compute_dtype), rp)
    tol = 1e-5 if mode == "fp32" else 2e-2
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)
    assert abs(float(got_aux) - float(want_aux)) <= 1e-6


def test_model_moe_layers_route_through_ep(one_rank_mesh, monkeypatch):
    """``Model.forward`` and ``decode_step`` of an MoE model call
    ``moe_ffn_ep`` on every MoE layer; on a 1 x 1 mesh the logits are
    those without a mesh bit for bit."""
    from repro_torch.models import moe
    from repro_torch.models.model import Model
    from repro_torch.parallel.sharding import (activation_sharding,
                                               default_activation_rules)
    cfg = reduced(get_config(MOONSHOT))
    model = Model(cfg, device="cpu")
    params = model.init(torch.Generator("cpu").manual_seed(0))
    tokens = torch.randint(0, cfg.vocab, (2, 6),
                           generator=torch.Generator().manual_seed(1))
    calls = []
    real = moe.moe_ffn_ep

    def counting(*a, **k):
        calls.append(1)
        return real(*a, **k)
    monkeypatch.setattr(moe, "moe_ffn_ep", counting)
    plain, _ = model.forward(params, tokens)
    assert len(calls) == cfg.n_layers
    with activation_sharding(one_rank_mesh, default_activation_rules(
            one_rank_mesh, seq_sharded=False)):
        sharded, _ = model.forward(params, tokens)
        caches = model.init_cache(2, 8)
        model.decode_step(params, caches, tokens[:, :1], 0)
    assert len(calls) == 3 * cfg.n_layers
    assert torch.equal(plain, sharded)


def test_train_moe_through_ep_on_the_host_mesh():
    """``train()`` builds its step on ``make_host_mesh()`` (a one-rank
    group it releases after): a reduced moonshot's MoE layers route
    through ``moe_ffn_ep`` under grad, and its losses are those of the
    same steps without a mesh bit for bit."""
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.launch import train as T_train
    from repro_torch.models import moe
    from repro_torch.models.model import Model
    from repro_torch.optim import adamw
    calls = []
    real = moe.moe_ffn_ep

    def counting(*a, **k):
        calls.append(torch.is_grad_enabled())
        return real(*a, **k)
    steps = 3
    mp = pytest.MonkeyPatch()
    mp.setattr(moe, "moe_ffn_ep", counting)
    try:
        got = T_train.train(MOONSHOT, steps=steps, batch=2, seq_len=8,
                            log_every=100, device="cpu")
    finally:
        mp.undo()
    assert not torch.distributed.is_initialized()
    cfg = reduced(get_config(MOONSHOT))
    assert len(calls) == steps * cfg.n_layers and all(calls)
    ocfg = adamw.AdamWConfig(lr=3e-3, total_steps=steps, warmup_steps=1)
    model = Model(cfg, device="cpu")
    step = T_train.make_train_step(model, None, ocfg)
    params = model.init(torch.Generator("cpu").manual_seed(0))
    state = {"params": params, "opt": adamw.init(params), "err": {}}
    data = SyntheticLM(DataConfig(cfg.vocab, 8, 2, seed=0))
    want = []
    for s in range(steps):
        state, loss = step(state, data.batch(s, device="cpu"))
        want.append((s, float(loss)))
    assert got == want
