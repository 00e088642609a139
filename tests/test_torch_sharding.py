"""The sharding rules and the dry run's pod placement against the
reference's, spec for spec.

The reference's rule tables read a mesh's axis names and sizes only, so
both sides run on shape-only meshes (the reference's ``FakeMesh``
pattern, the port's ``ShapeMesh``) of 16 x 16, 2 x 16 x 16, 4 x 1, 2 x 2
and 1 x 4.  The reference side runs once, in a subprocess: importing
``repro.launch.dryrun`` sets ``XLA_FLAGS`` for 512 host devices, which
must not reach this process (``tests/conftest.py``).  It builds every
leaf of the ten archs at full width with ``jax.eval_shape`` and prints
their specs, the activation rules, ``data_axes``, the batch and cache
specs of every (arch, shape) and the bytes one card holds under its
placement; the port builds the same trees under ``FakeTensorMode``
(nothing allocated).  A port per-layer leaf (one dict per layer in a
list) holds the reference's stacked spec without its leading ``None``.

The in-process ``shard`` check starts a one-rank gloo group in a fixture
that always destroys it, so no group leaks into a later test file on the
same worker.
"""

import json
import math
import pathlib
import subprocess
import sys

import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.configs import ALL_ARCHS, get_config
from repro_torch.configs.base import SHAPES
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import (ShapeMesh, ensure_process_group,
                                     make_production_mesh,
                                     release_process_group)
from repro_torch.models.model import Model
from repro_torch.optim import adamw
from repro_torch.parallel.sharding import (P, activation_sharding, data_axes,
                                           default_activation_rules,
                                           param_pspec, shard, to_placements,
                                           tree_pspecs)

ROOT = pathlib.Path(__file__).resolve().parent.parent
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "4x1": ((4, 1), ("data", "model")),
          "2x2": ((2, 2), ("data", "model")),
          "1x4": ((1, 4), ("data", "model"))}
#: decode cells of the cache check: the reference's shapes and the
#: batch-1 branch at a batch the data axis does divide
DECODE_CELLS = (("decode_32k", 128, 32768), ("long_500k", 1, 524288),
                ("decode_b2", 2, 4096))
#: the cell whose per-card bytes are held to the reference's specs
BYTES_CELLS = (("phi4-mini-3.8b", "train_4k"),
               ("moonshot-v1-16b-a3b", "decode_32k"),
               ("mamba2-130m", "train_4k"))

REF_SCRIPT = r'''
import json, sys
import jax, jax.numpy as jnp, numpy as np
from repro.configs import ALL_ARCHS, get_config
from repro.configs.base import SHAPES, ShapeConfig
from repro.launch import dryrun
from repro.models.model import Model
from repro.optim import adamw
from repro.parallel.sharding import (data_axes, default_activation_rules,
                                     tree_pspecs)

MESHES = json.loads(sys.argv[1])
DECODE = json.loads(sys.argv[2])
BYTES = json.loads(sys.argv[3])


class FakeMesh:
    def __init__(self, shape, names):
        self.axis_names = tuple(names)
        self.devices = np.empty(tuple(shape))


def spec(s):
    return [list(e) if isinstance(e, tuple) else e for e in s]


def path_specs(tree, mesh):
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree_pspecs(tree, mesh),
        is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    out = {}
    for path, s in flat:
        name = "/".join(str(getattr(k, "key", getattr(k, "name", k)))
                        for k in path)
        out[name] = spec(s)
    return out


def local_bytes(shapes, specs, mesh):
    sizes = dict(zip(mesh.axis_names, mesh.devices.shape))
    total = 0
    for x, s in zip(jax.tree.leaves(shapes), jax.tree.leaves(
            specs, is_leaf=lambda v: isinstance(v,
                                                jax.sharding.PartitionSpec))):
        if x.ndim == 0:
            continue
        n = 1
        for d, e in enumerate(tuple(s)):
            axes = e if isinstance(e, tuple) else (e,)
            k = 1
            for a in axes:
                k *= sizes.get(a, 1) if a is not None else 1
            assert x.shape[d] % k == 0
            n *= x.shape[d] // k
        for d in range(len(tuple(s)), x.ndim):
            n *= x.shape[d]
        total += n * x.dtype.itemsize
    return total


out = {"params": {}, "opt": {}, "rules": {}, "data_axes": {}, "batch": {},
       "cache": {}, "bytes": {}}
meshes = {k: FakeMesh(*v) for k, v in MESHES.items()}
for name, mesh in meshes.items():
    out["data_axes"][name] = list(data_axes(mesh))
    for seq in (False, True):
        for b1 in (False, True):
            r = default_activation_rules(mesh, seq_sharded=seq, batch_1=b1)
            out["rules"][f"{name}|{seq}|{b1}"] = {
                k: spec(v) for k, v in r.items()}
for arch in ALL_ARCHS:
    cfg = get_config(arch)
    model = Model(cfg)
    pshapes = model.param_shapes()
    opt = jax.eval_shape(adamw.init, pshapes)
    for name, mesh in meshes.items():
        out["params"][f"{arch}|{name}"] = path_specs(pshapes, mesh)
        for shape_name, shape in SHAPES.items():
            b = dryrun.input_specs(cfg, shape, mesh)["batch"]
            out["batch"][f"{arch}|{shape_name}|{name}"] = {
                k: spec(v) for k, v in
                dryrun.batch_pspecs(cfg, shape, mesh, b).items()}
        if arch == "phi4-mini-3.8b":
            out["opt"][name] = path_specs(opt, mesh)
    for shape_name, b, s in DECODE:
        shape = ShapeConfig(shape_name, s, b, "decode")
        kvqs = (False, True) if cfg.family in ("dense", "moe") else (False,)
        for kvq in kvqs:
            caches = jax.eval_shape(lambda: model.init_cache(
                b, s, dtype=jnp.bfloat16, kv_quant=kvq))
            for name, mesh in meshes.items():
                for kvs in (False, True):
                    out["cache"][f"{arch}|{shape_name}|{kvq}|{name}|{kvs}"] = {
                        k: spec(v) for k, v in dryrun.cache_pspecs(
                            cfg, shape, mesh, caches,
                            kv_seq_shard=kvs).items()}
mesh = meshes["16x16"]
for arch, shape_name in BYTES:
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    model = Model(cfg)
    pshapes = model.param_shapes()
    total = local_bytes(pshapes, tree_pspecs(pshapes, mesh), mesh)
    batch = dryrun.input_specs(cfg, shape, mesh)["batch"]
    total += local_bytes(batch, dryrun.batch_pspecs(cfg, shape, mesh,
                                                    batch), mesh)
    if shape.kind == "train":
        opt = jax.eval_shape(adamw.init, pshapes)
        total += local_bytes(opt, tree_pspecs(opt, mesh), mesh)
    else:
        caches = jax.eval_shape(lambda: model.init_cache(
            shape.global_batch, shape.seq_len, dtype=jnp.bfloat16))
        total += local_bytes(caches, dryrun.cache_pspecs(
            cfg, shape, mesh, caches), mesh)
    out["bytes"][f"{arch}|{shape_name}"] = total
print(json.dumps(out))
'''


@pytest.fixture(scope="module")
def ref():
    """The reference's specs, from one subprocess (see the module
    docstring)."""
    out = subprocess.run(
        [sys.executable, "-c", REF_SCRIPT, json.dumps(MESHES),
         json.dumps(DECODE_CELLS), json.dumps(BYTES_CELLS)],
        capture_output=True, text=True, timeout=300, cwd=str(ROOT),
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin",
             "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def _mesh(name: str) -> ShapeMesh:
    return ShapeMesh(*MESHES[name])


def _spec(s) -> list:
    return [list(e) if isinstance(e, tuple) else e for e in s]


def _port_path_specs(tree, mesh) -> dict:
    """``{reference path: spec}`` of a port tree: a list's index is not
    on the path, and a per-layer leaf's spec gets the stacked leading
    ``None``; every layer of one list must agree."""
    out: dict = {}

    def walk(t, s, prefix, per_layer):
        if isinstance(t, dict):
            for k in t:
                walk(t[k], s[k], prefix + (str(k),), per_layer)
        elif isinstance(t, list):
            for x, y in zip(t, s):
                walk(x, y, prefix, True)
        elif isinstance(t, tuple) and hasattr(t, "_fields"):
            for f in t._fields:
                walk(getattr(t, f), getattr(s, f), prefix + (f,),
                     per_layer)
        elif isinstance(t, torch.Tensor):
            got = ([None] if per_layer else []) + _spec(s)
            name = "/".join(prefix)
            assert out.setdefault(name, got) == got, name
    walk(tree, tree_pspecs(tree, mesh), (), False)
    return out


@pytest.fixture(scope="module")
def port_params():
    with FakeTensorMode():
        return {a: Model(get_config(a), device="cpu").init(
            torch.Generator("cpu").manual_seed(0)) for a in ALL_ARCHS}


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_param_specs_equal_reference_on_every_leaf(ref, port_params,
                                                   mesh_name):
    """Every leaf of the ten archs at full width, and phi4-mini's AdamW
    state (the reference's step counter is a scalar leaf; the port's is a
    host int, placed nowhere)."""
    mesh = _mesh(mesh_name)
    for arch in ALL_ARCHS:
        want = ref["params"][f"{arch}|{mesh_name}"]
        got = _port_path_specs(port_params[arch], mesh)
        assert got == want, arch
    with FakeTensorMode():
        opt = adamw.init(port_params["phi4-mini-3.8b"])
    want = ref["opt"][mesh_name]
    got = _port_path_specs(opt, mesh)
    assert got == {k: v for k, v in want.items() if k != "step"}
    assert want["step"] == []


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_activation_rules_and_data_axes_equal_reference(ref, mesh_name):
    mesh = _mesh(mesh_name)
    assert list(data_axes(mesh)) == ref["data_axes"][mesh_name]
    for seq in (False, True):
        for b1 in (False, True):
            got = default_activation_rules(mesh, seq_sharded=seq,
                                           batch_1=b1)
            assert {k: _spec(v) for k, v in got.items()} \
                == ref["rules"][f"{mesh_name}|{seq}|{b1}"]


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_batch_specs_equal_reference(ref, mesh_name):
    mesh = _mesh(mesh_name)
    for arch in ALL_ARCHS:
        cfg = get_config(arch)
        for shape_name, shape in SHAPES.items():
            with FakeTensorMode():
                batch = dryrun.input_specs(cfg, shape, "cpu")["batch"]
            got = dryrun.batch_pspecs(cfg, shape, mesh, batch)
            assert {k: _spec(v) for k, v in got.items()} \
                == ref["batch"][f"{arch}|{shape_name}|{mesh_name}"], \
                (arch, shape_name)


@pytest.mark.parametrize("cell", DECODE_CELLS, ids=lambda c: c[0])
def test_cache_specs_equal_reference(ref, cell):
    """Every decode cache key of the ten archs, with and without
    ``kv_seq_shard``, on every mesh: the batch-over-data branch
    (``decode_32k``), the batch-1 sequence-over-data branch
    (``long_500k``, batch 1 below the data axes) and a batch of 2 (not
    batch 1, so sequence sharding stays off)."""
    from repro_torch.configs.base import ShapeConfig
    shape_name, b, s = cell
    shape = ShapeConfig(shape_name, s, b, "decode")
    for arch in ALL_ARCHS:
        cfg = get_config(arch)
        model = Model(cfg, device="cpu")
        kvqs = (False, True) if cfg.family in ("dense", "moe") else (False,)
        for kvq in kvqs:
            with FakeTensorMode():
                caches = model.init_cache(b, s, dtype=torch.bfloat16,
                                          kv_quant=kvq)
            for mesh_name in MESHES:
                for kvs in (False, True):
                    got = dryrun.cache_pspecs(cfg, shape, _mesh(mesh_name),
                                              caches, kv_seq_shard=kvs)
                    key = f"{arch}|{shape_name}|{kvq}|{mesh_name}|{kvs}"
                    assert {k: _spec(v) for k, v in got.items()} \
                        == ref["cache"][key], key


@pytest.mark.parametrize("cell", BYTES_CELLS, ids="|".join)
def test_pod_argument_bytes_equal_reference_local_shapes(ref, cell):
    """The dry run's per-card argument bytes on 16 x 16 are the sum of
    the local shard sizes under the reference's own specs."""
    arch, shape_name = cell
    mesh = make_production_mesh()
    rec = dryrun.run_pod_cell(arch, shape_name, out_dir=None,
                              serve_quant=False, kv_quant=False,
                              bf16_params=False, weight_only_qat=False,
                              mode=None, microbatch=1)
    assert rec["status"] == "placed", rec.get("error")
    assert rec["mesh"] == "16x16" and rec["chips"] == mesh.size() == 256
    assert rec["memory_analysis"]["argument_bytes"] \
        == ref["bytes"][f"{arch}|{shape_name}"]


@pytest.mark.parametrize("kwargs,mesh_name,chips", [
    (dict(multi_pod=True), "2x16x16", 512),
    (dict(kv_seq_shard=True), "16x16", 256),
    (dict(multi_pod=True, kv_seq_shard=True), "2x16x16", 512)])
def test_pod_records(kwargs, mesh_name, chips, tmp_path):
    """``run_cell`` with ``multi_pod`` or ``kv_seq_shard`` counts the
    sharded step on one card of the pod mesh and writes the reference's
    record: per-card counts, collective bytes and the roofline over
    ``chips`` cards, per-card bytes by group, ``fits_hbm`` against one
    H100."""
    rec = dryrun.run_cell("phi4-mini-3.8b", "decode_32k", out_dir=tmp_path,
                          **kwargs)
    assert rec["status"] == "ok", rec.get("error")
    assert rec["mesh"] == mesh_name and rec["chips"] == chips
    mem = rec["memory_analysis"]
    # the counter's local shards are the rule tables' per-card bytes
    assert mem["argument_bytes"] == sum(mem["argument_bytes_by_group"]
                                        .values())
    assert set(mem["argument_bytes_by_group"]) == {"params", "caches",
                                                   "batch"}
    assert mem["fits_hbm"] == (mem["argument_bytes"] + mem["temp_bytes"]
                               <= mem["hbm_bytes"])
    assert rec["stats"]["flops"] > 0 and rec["stats"]["collective_bytes"] > 0
    assert rec["roofline"]["chips"] == chips
    assert rec["roofline"]["collective_bytes_per_device"] \
        == rec["stats"]["collective_bytes"]
    tag = "__kvshard" if kwargs.get("kv_seq_shard") else ""
    saved = json.loads((tmp_path / f"phi4-mini-3.8b__decode_32k__"
                        f"{mesh_name}{tag}.json").read_text())
    assert saved["memory_analysis"] == mem
    if kwargs.get("kv_seq_shard"):
        assert "kv_seq_shard" in rec["notes"]
        plain = dryrun.run_pod_cell(
            "phi4-mini-3.8b", "decode_32k", out_dir=None,
            multi_pod=kwargs.get("multi_pod", False), serve_quant=False,
            kv_quant=False, bf16_params=False, weight_only_qat=False,
            mode=None, microbatch=1)
        # sharding the cache's sequence over "model" divides its bytes
        assert mem["argument_bytes_by_group"]["caches"] * 16 \
            == plain["memory_analysis"]["argument_bytes_by_group"]["caches"]


def test_pod_record_refuses_measure():
    with pytest.raises(ValueError, match="measure"):
        dryrun.run_cell("phi4-mini-3.8b", "decode_32k", multi_pod=True,
                        measure=True, out_dir=None)


# ---------------------------------------------------------------------------
# the reference's tests/test_sharding.py cases
# ---------------------------------------------------------------------------

MESH = ShapeMesh((16, 16), ("data", "model"))


@pytest.mark.parametrize("path,shape,stacked,want", [
    # TP spec for an attention projection
    ("layers/wq", (48, 8192, 8192), True, P(None, "data", "model")),
    # mamba2's vocab 50280 does not divide by 16: FSDP-shard d instead
    ("embed", (50280, 768), False, P(None, "data")),
    ("embed", (163840, 2048), False, P("model", "data")),
    # expert parallelism
    ("layers/w_experts_in", (48, 64, 2048, 1408), True,
     P(None, "model", "data", None)),
    # small params replicated
    ("layers/ln1", (48, 2048), True, P(None, None)),
    ("final_norm", (2048,), False, P(None)),
    # in_proj's inner dim 3352 % 16 != 0: only the FSDP axis survives
    ("layers/in_proj", (24, 768, 3352), True, P(None, "data", None)),
    # the port's unstacked per-layer leaf of the same weight
    ("layers/in_proj", (768, 3352), False, P("data", None))])
def test_param_pspec_cases(path, shape, stacked, want):
    assert param_pspec(path, shape, stacked, MESH) == want


def test_tree_pspecs_structure():
    params = {"embed": torch.zeros((256, 64)),
              "layers": [{"wq": torch.zeros((64, 64)),
                          "ln1": torch.zeros((64,))} for _ in range(2)]}
    specs = tree_pspecs(params, None)
    # without a mesh every axis divides: the rules' specs as they stand
    assert specs == {"embed": P("model", "data"),
                     "layers": [{"wq": P("data", "model"),
                                 "ln1": P(None)}] * 2}


def test_default_rules_shapes():
    rules = default_activation_rules(ShapeMesh((1,), ("data",)),
                                     seq_sharded=False)
    assert "residual" in rules and "moe_buffer" in rules


def test_to_placements():
    from torch.distributed.tensor import Replicate, Shard
    mesh = ShapeMesh((2, 16, 16), ("pod", "data", "model"))
    # a tuple entry shards one tensor dim over several mesh dims, major
    # to minor
    assert to_placements(P(("pod", "data"), None, "model"), mesh) \
        == [Shard(0), Shard(0), Shard(2)]
    assert to_placements(P(None, None), mesh) == [Replicate()] * 3
    with pytest.raises(ValueError, match="mesh order"):
        to_placements(P(("data", "pod")), mesh)
    with pytest.raises(ValueError, match="not an axis"):
        to_placements(P("experts"), mesh)
    with pytest.raises(ValueError, match="twice"):
        to_placements(P("data", "data"), mesh)


@pytest.fixture
def cpu_mesh():
    """A 1 x 1 ("data", "model") gloo mesh in this process, its group
    destroyed however the test ends."""
    from repro_torch.launch.mesh import make_host_mesh
    ensure_process_group("cpu")
    try:
        yield make_host_mesh(device_type="cpu")
    finally:
        release_process_group()
    assert not torch.distributed.is_initialized()


def test_activation_sharding_context(cpu_mesh):
    """``shard`` is the identity outside the context and on a plain
    tensor; inside it redistributes a ``DTensor`` to the rule's
    placements, never changing a value."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from repro_torch.parallel.sharding import distribute
    x = torch.arange(2 * 4 * 8, dtype=torch.float32).reshape(2, 4, 8)
    assert shard(x, "residual") is x
    d = distribute(x, cpu_mesh, P(None, None, None))
    assert shard(d, "residual") is d
    rules = default_activation_rules(cpu_mesh, seq_sharded=True)
    with activation_sharding(cpu_mesh, rules):
        assert shard(x, "residual") is x
        out = shard(d, "residual")
        assert isinstance(out, DTensor)
        assert list(out.placements) == [Shard(0), Shard(1)]
        assert torch.equal(out.full_tensor(), x)
        assert shard(d, "no such name") is d
    assert list(d.placements) == [Replicate(), Replicate()]


def test_tree_shardings_places_every_leaf(cpu_mesh):
    """Every tensor leaf (a quantized weight's ``data`` and ``scale``
    too) becomes a ``DTensor`` that holds the leaf's values; a host
    scalar stays."""
    from torch.distributed.tensor import DTensor
    from repro_torch.configs.base import reduced
    from repro_torch.models.tree import tree_flatten
    from repro_torch.parallel.sharding import tree_shardings
    cfg = reduced(get_config("phi4-mini-3.8b"))
    model = Model(cfg, device="cpu")
    floats = model.init(torch.Generator("cpu").manual_seed(0))
    params = model.quantize_params(floats)
    state = {"params": params, "opt": adamw.init(floats)}
    placed = tree_shardings(cpu_mesh, state)
    leaves, _ = tree_flatten(state)
    got, _ = tree_flatten(placed)
    assert len(leaves) == len(got)
    assert placed["opt"].step == 0
    from repro_torch.quant.qlinear import QuantizedTensor
    n = 0
    for a, b in zip(leaves, got):
        pairs = ([(a.data, b.data), (a.scale, b.scale)]
                 if isinstance(a, QuantizedTensor) else [(a, b)])
        for x, y in pairs:
            if isinstance(x, torch.Tensor):
                assert isinstance(y, DTensor)
                assert torch.equal(y.full_tensor(), x)
                n += 1
    assert n > 3 * len(params["layers"])
    assert any(isinstance(v, QuantizedTensor)
               for v in params["layers"][0].values())
    assert math.prod(cpu_mesh.shape) == 1
