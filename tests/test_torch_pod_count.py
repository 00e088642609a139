"""The sharded step under the op counter: the dry run's pod cells counted
on one card of a ``DeviceMesh`` (``launch/dryrun.count_sharded``).

Reduced configs (two layers, d_model 64), W8A8 phi4-mini-3.8b decode on
an int8 KV cache and prefill, and both in the float32 policy, on a 2 x 2
``("data", "model")`` mesh:

1. the reference's ``build_cell`` for the same cells, compiled on 4
   forced host devices in a subprocess (``XLA_FLAGS`` set in its own
   environment only) and read by ``analyze_compiled``: the port's
   fake-group count holds the reference's per-device product FLOPs within
   ``PRODUCT_FLOPS_RTOL``; collective bytes by kind are not compared
   (GSPMD and DTensor pick their own collectives), but each side has
   collectives where the other has;
2. 4 real gloo ranks run the same sharded step: each rank's count equals
   the fake-group count field for field; the gathered logits
   (``full_tensor()``) are within one bf16 ulp of the unsharded port
   step's (a sum over a split dim meets in another order) and the
   dequantized caches within the serving tests' bar (``2e-2``); in the
   float32 policy logits and caches are within ``FP32_RTOL`` (1e-6) of
   it; the logits are within the serving tests' bar of the reference's
   ``decode_step`` / ``forward`` on the same params and tokens;
3. on a 1 x 1 mesh the fake-group count equals the one-card dry run's
   count exactly, with no collective;
4. reduced mamba2's (SSM) and moonshot's (EP) train cells count on 2 x 2;
5. one sharded product on a 4-rank fake mesh counts its local FLOPs once
   (DTensor's global-shape propagation run is not counted).
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

from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig, reduced
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import fake_process_mesh

ROOT = pathlib.Path(__file__).resolve().parent.parent
ARCH = "phi4-mini-3.8b"
WORLD = 4
MESH = (2, 2)
AXES = ("data", "model")
#: the test cells: (seq, batch, kind), the cell's options and whether
#: the cache's sequence is split over "model" (``kv_seq_shard``)
CELLS = {
    "pod_decode": ((32, 4, "decode"), dict(serve_quant=True, kv_quant=True),
                   False),
    "pod_decode_kvshard": ((32, 4, "decode"),
                           dict(serve_quant=True, kv_quant=True), True),
    "pod_prefill": ((16, 4, "prefill"), dict(serve_quant=True,
                                             kv_quant=False), False),
    # the float32 policy: no int8 code or bf16 rounding to move, so the
    # sharded step parts from the unsharded one only by the order in
    # which the sums over split dims meet
    "pod_decode_fp32": ((32, 4, "decode"),
                        dict(serve_quant=False, kv_quant=False, mode="fp32"),
                        False),
    "pod_prefill_fp32": ((16, 4, "prefill"),
                         dict(serve_quant=False, kv_quant=False,
                              mode="fp32"), False),
}
TRAIN_CELLS = {
    "mamba2-130m": (64, 4), "moonshot-v1-16b-a3b": (16, 4)}
KW = dict(bf16_params=False, weight_only_qat=False, mode=None, microbatch=1)
#: the port's per-card product FLOPs against the reference's per-device
#: ones: its flash attention counts the causal half of the (q, k) pairs
#: the reference's dense attention multiplies whole (at 16 tokens a few
#: per cent of the cell), and the two partitioners replicate other work
PRODUCT_FLOPS_RTOL = 0.10
#: the serving tests' bar against the reference (``test_torch_serve.py``)
REF_TOL = 2e-2
#: the float32 cells' sharded logits against the unsharded step's,
#: relative to their largest magnitude
FP32_RTOL = 1e-6


def _fp32(name: str) -> bool:
    return CELLS[name][1].get("mode") == "fp32"


def _shape(name: str) -> ShapeConfig:
    if name in CELLS:
        (s, b, kind), _, _ = CELLS[name]
    else:
        s, b = TRAIN_CELLS[name.split("|")[0]]
        kind = "train"
    return ShapeConfig(name, s, b, kind)


def _patch(mp) -> None:
    """Reduced configs and the test shapes in the dry run."""
    mp.setattr(dryrun, "get_config", lambda a: reduced(get_config(a)))
    shapes = dict(dryrun.ONE_CARD_SHAPES)
    shapes.update({n: _shape(n) for n in CELLS})
    shapes.update({f"{a}|train": _shape(f"{a}|train")
                   for a in TRAIN_CELLS})
    mp.setattr(dryrun, "ONE_CARD_SHAPES", shapes)


def _fake_count(name: str, mesh_shape=MESH, arch=ARCH, **opts) -> dict:
    """The fake-group count of a cell on a mesh of ``mesh_shape``."""
    with pytest.MonkeyPatch.context() as mp:
        _patch(mp)
        with fake_process_mesh(mesh_shape, AXES) as mesh, FakeTensorMode():
            _, stats, alias, _, _ = dryrun.count_sharded(
                arch, name, mesh, device="cpu", **{**KW, **opts})
    return {"stats": stats.as_dict(), "alias": alias}


# ------------------------------------------------- the 4 gloo ranks' run

def _rank_main(rank: int, world: int, init: str, out_dir: str,
               params_path: str) -> None:
    """One of 4 gloo ranks: both cells' sharded steps on the reference's
    params, counted; its counts, and rank 0 the gathered outputs."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    dist.init_process_group("gloo", init_method=f"file://{init}",
                            rank=rank, world_size=world)
    try:
        with pytest.MonkeyPatch.context() as mp:
            _patch(mp)
            both = torch.load(params_path, weights_only=False)
            mesh = DeviceMesh("cpu", torch.arange(world).reshape(MESH),
                              mesh_dim_names=AXES)
            counts, outs = {}, {}
            for name, (_, opts, kvs) in CELLS.items():
                result, stats, alias, _, _ = dryrun.count_sharded(
                    ARCH, name, mesh, device="cpu",
                    params=both["float" if _fp32(name) else "w8a8"],
                    kv_seq_shard=kvs, **{**KW, **opts})
                counts[name] = {"stats": stats.as_dict(), "alias": alias}
                outs[name] = _full(result)
            outs["grads"] = _product_grads(mesh)
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(counts, f)
        if rank == 0:
            torch.save(outs, os.path.join(out_dir, "outs.pt"))
    finally:
        dist.barrier()
        dist.destroy_process_group()


#: two float64 products (a tanh between) placed column- then row-split
#: (x by rows on "data", the weights' model dims on "model") or with the
#: weights split on "data" alone (FSDP): specs of x, w1, w2
GRAD_CASES = {"colrow": (("data", None, None), ("data", "model"),
                         ("model", "data")),
              "fsdp": (("data", None, None), ("data", None), (None, "data"))}


def _grad_inputs():
    g = torch.Generator().manual_seed(0)
    return tuple(torch.randn(*s, generator=g, dtype=torch.float64)
                 for s in ((4, 3, 8), (8, 6), (6, 8)))


def _product_grads(mesh) -> dict:
    """Each case's output and the gradients of its loss on this rank's
    placed inputs, whole (collectives)."""
    from repro_torch.parallel.sharding import P, place
    from repro_torch.quant.qlinear import _matmul
    out = {}
    for name, specs in GRAD_CASES.items():
        x, w1, w2 = (place(t, mesh, P(*s)).requires_grad_(True)
                     for t, s in zip(_grad_inputs(), specs))
        y = _matmul(torch.tanh(_matmul(x, w1)), w2)
        (y * y).sum().backward()
        out[name] = [t.detach().full_tensor()
                     for t in (y, x.grad, w1.grad, w2.grad)]
    return out


def _full(result) -> dict:
    """The step's logits and caches as whole tensors (a collective)."""
    logits, caches = result if isinstance(result, tuple) else (result, {})
    out = {"logits": logits.full_tensor()}
    out.update({k: v.full_tensor() for k, v in caches.items()})
    return out


def _unsharded(name: str, params) -> tuple:
    """The cell's unsharded port step on the same params: its outputs
    and its batch."""
    (_, _, kind), opts, _ = CELLS[name]
    with pytest.MonkeyPatch.context() as mp:
        _patch(mp)
        step, args, _ = dryrun.build_cell(ARCH, name, device="cpu",
                                          params=params, **{**KW, **opts})
        result = step(*args)
    logits, caches = result if isinstance(result, tuple) else (result, {})
    return {"logits": logits, **caches}, args[-1]


REF_SCRIPT = r'''
import json, sys
import jax
assert jax.device_count() == 4, jax.device_count()
from repro.configs import get_config
from repro.configs.base import ShapeConfig, reduced
from repro.core import hlo_analysis as H
import repro.launch.dryrun as RD
from repro.launch.mesh import compat_make_mesh

cells = json.loads(sys.argv[1])
RD.get_config = lambda a: reduced(get_config(a))
out = {}
for name, ((s, b, kind), opts, kvs) in cells.items():
    RD.SHAPES[name] = ShapeConfig(name, s, b, kind)
    mesh = compat_make_mesh((2, 2), ("data", "model"))
    with mesh:
        fn, args, _ = RD.build_cell("phi4-mini-3.8b", name, mesh,
                                    kv_seq_shard=kvs, **opts)
        text = fn.lower(*args).compile().as_text()
    full = H.analyze_hlo_text(text)
    elementwise = H._ELEMENTWISE_FLOP_OPS
    H._ELEMENTWISE_FLOP_OPS = frozenset()       # the products alone
    products = H.analyze_hlo_text(text).flops
    H._ELEMENTWISE_FLOP_OPS = elementwise
    out[name] = {"product_flops": products,
                 "collective_bytes_by_kind": full.collectives.bytes_by_kind}
print(json.dumps(out))
'''


def _reference_params():
    """Reduced phi4-mini's params drawn by the reference and carried to
    the port, float32 and W8A8, beside the reference's model for each
    (the W8A8 one of the config, a float32 one)."""
    import jax
    from repro.configs import get_config as r_get_config
    from repro.configs.base import reduced as r_reduced
    from repro.models.model import Model as RModel
    from repro.quant.qlinear import QuantizedTensor as RQuantizedTensor
    from repro_torch.models.convert import from_reference_params

    def to_numpy_tree(tree):
        if isinstance(tree, RQuantizedTensor):
            return {"data": np.asarray(tree.data),
                    "scale": np.asarray(tree.scale), "mode": tree.mode,
                    "orig_shape": tuple(tree.orig_shape)}
        if isinstance(tree, dict):
            return {k: to_numpy_tree(v) for k, v in tree.items()}
        return np.asarray(tree)
    rcfg = r_reduced(r_get_config(ARCH))
    rmodel = RModel(rcfg)
    floats = rmodel.init(jax.random.key(0))
    rparams = rmodel.quantize_params(floats)
    cfg = reduced(get_config(ARCH))
    return ({"w8a8": (rmodel, rparams),
             "float": (RModel(dataclasses.replace(rcfg, quant="fp32")),
                       floats)},
            {"w8a8": from_reference_params(cfg, to_numpy_tree(rparams),
                                           device="cpu"),
             "float": from_reference_params(cfg, to_numpy_tree(floats),
                                            device="cpu")})


@pytest.fixture(scope="module")
def pod(tmp_path_factory):
    """The reference's compiled cells (subprocess) and the 4 gloo ranks'
    run (spawn), started together; the fake-group counts and the
    unsharded steps in this process meanwhile."""
    import torch.multiprocessing as mp
    tmp = tmp_path_factory.mktemp("pod")
    reference, tparams = _reference_params()
    params_path = tmp / "params.pt"
    torch.save(tparams, params_path)
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin",
           "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=4"}
    ref = subprocess.Popen(
        [sys.executable, "-c", REF_SCRIPT, json.dumps(CELLS)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        cwd=str(ROOT))
    try:
        init = tempfile.mktemp(dir=tmp)
        ctx = mp.start_processes(_rank_main,
                                 args=(WORLD, init, str(tmp),
                                       str(params_path)),
                                 nprocs=WORLD, join=False,
                                 start_method="spawn")
        fake = {n: _fake_count(n, params=None, kv_seq_shard=kvs, **opts)
                for n, (_, opts, kvs) in CELLS.items()}
        unsharded = {n: _unsharded(n, tparams["float" if _fp32(n)
                                               else "w8a8"])
                     for n in CELLS}
        deadline = time.monotonic() + 300
        while not ctx.join(timeout=2):
            if time.monotonic() > deadline:
                for p in ctx.processes:
                    p.kill()
                raise AssertionError("the 4 ranks did not end in 300 s")
        out, err = ref.communicate(timeout=300)
        assert ref.returncode == 0, err[-3000:]
    finally:
        if ref.poll() is None:
            ref.kill()
    counts = [json.loads((tmp / f"rank{r}.json").read_text())
              for r in range(WORLD)]
    return {"ref": json.loads(out.strip().splitlines()[-1]),
            "fake": fake, "ranks": counts,
            "outs": torch.load(tmp / "outs.pt", weights_only=False),
            "unsharded": unsharded, "reference": reference}


def _product_flops(stats: dict) -> float:
    by = stats["flops_by_class"]
    return by["int8"] + by["bf16"] + by["fp32_dot"]


@pytest.mark.parametrize("name", list(CELLS))
def test_product_flops_match_the_reference_per_device(pod, name):
    got = _product_flops(pod["fake"][name]["stats"])
    want = pod["ref"][name]["product_flops"]
    print(name, "port / reference per-device product FLOPs:",
          got, want, got / want)
    assert got == pytest.approx(want, rel=PRODUCT_FLOPS_RTOL)


@pytest.mark.parametrize("name", list(CELLS))
def test_collectives_where_the_reference_has_them(pod, name):
    port = pod["fake"][name]["stats"]["collective_bytes_by_kind"]
    ref = pod["ref"][name]["collective_bytes_by_kind"]
    print(name, "port:", port, "reference:", ref)
    assert (sum(port.values()) > 0) == (sum(ref.values()) > 0)


@pytest.mark.parametrize("rank", range(WORLD))
@pytest.mark.parametrize("name", list(CELLS))
def test_each_rank_counts_the_fake_group_count(pod, name, rank):
    """Every rank's real count is the fake group's (rank 0's), field for
    field.  Under ``kv_seq_shard`` the token's k, v and scales are
    written only by the ranks whose part of the sequence holds its slot
    (model coordinate 1 of 2 at the last position): they count the
    written rows' bytes twice more, nothing else."""
    got, want = pod["ranks"][rank][name], pod["fake"][name]
    (_, b, _), _, kvs = CELLS[name]
    if kvs and rank % MESH[1] == 1:
        cfg = reduced(get_config(ARCH))
        rows = b // MESH[0] * cfg.n_kv_heads
        written = cfg.n_layers * 2 * (2 * rows * cfg.head_dim + 2 * rows * 4)
        assert got["stats"]["bytes_accessed"] \
            == want["stats"]["bytes_accessed"] + written
        got = {**got, "stats": {**got["stats"], "bytes_accessed":
                                want["stats"]["bytes_accessed"]}}
    assert got == want


def _ulp_bf16(scale: float) -> float:
    """One bf16 ulp at magnitude ``scale``."""
    return 2.0 ** (np.floor(np.log2(scale)) - 7)


def _dequant(out: dict, key: str) -> torch.Tensor:
    t = out[key].to(torch.float64)
    return t * out[key + "_scale"].to(torch.float64)[..., None] \
        if key + "_scale" in out else t


@pytest.mark.parametrize("name", list(CELLS))
def test_sharded_outputs_near_the_unsharded_step(pod, name):
    """The W8A8 cells' logits within one bf16 ulp of their largest
    magnitude: a sum over a split dim (the norm's mean over d_model split
    on "data", a contraction split on "model") meets as ``Partial`` sums
    in another order than the unsharded sum's (the bf16 LM head's
    partials are rounded to bf16 before they meet).  Their dequantized
    caches within the serving tests' bar: one rounding of the residual
    moves a row's int8 scale and so its codes.  The float32 cells, where
    only that order differs, hold logits and caches to ``FP32_RTOL`` of
    their largest magnitude: the witness that the order explains the
    W8A8 cells' gap, and that no ``Partial`` is reduced in a narrower
    type than the unsharded step sums in."""
    want, _ = pod["unsharded"][name]
    got = pod["outs"][name]
    assert set(got) == set(want)
    for key, t in want.items():
        g = got[key]
        assert g.shape == t.shape and g.dtype == t.dtype, key
        diff = (g.to(torch.float64) - t.to(torch.float64)).abs()
        scale = float(t.abs().max().to(torch.float64))
        print(name, key, t.dtype, "max |diff|", float(diff.max()),
              "scale", scale, "differing", int((g != t).sum()), "of",
              t.numel())
        if _fp32(name):
            assert float(diff.max()) <= FP32_RTOL * scale, key
        elif key == "logits":
            assert float(diff.max()) <= _ulp_bf16(scale), key
    for key in ("k", "v"):
        if key in want:
            diff = (_dequant(got, key) - _dequant(want, key)).abs()
            assert float(diff.max()) <= REF_TOL, key


@pytest.mark.parametrize("name", list(CELLS))
def test_sharded_logits_within_the_reference_bar(pod, name):
    import jax.numpy as jnp
    rmodel, rparams = pod["reference"]["float" if _fp32(name) else "w8a8"]
    (s, b, kind), opts, _ = CELLS[name]
    _, batch = pod["unsharded"][name]
    tokens = jnp.asarray(batch["tokens"].numpy(), jnp.int32)
    if kind == "decode":
        caches = rmodel.init_cache(b, s, dtype=jnp.bfloat16,
                                   kv_quant=opts["kv_quant"])
        want, _ = rmodel.decode_step(rparams, caches, tokens,
                                     jnp.int32(batch["pos"]))
    else:
        want, _ = rmodel.forward(rparams, tokens, train=False,
                                 last_only=True)
    got = pod["outs"][name]["logits"].to(torch.float32).numpy()
    np.testing.assert_allclose(got, np.asarray(want, np.float32),
                               rtol=REF_TOL, atol=REF_TOL)


@pytest.mark.parametrize("name", ["pod_decode", "pod_prefill"])
def test_one_rank_mesh_counts_the_one_card_record(name):
    """On a 1 x 1 mesh every placement is whole: the count is the
    one-card dry run's, field for field, with no collective."""
    opts = CELLS[name][1]
    got = _fake_count(name, (1, 1), params=None, **opts)
    with pytest.MonkeyPatch.context() as mp:
        _patch(mp)
        rec = dryrun.run_cell(ARCH, name, out_dir=None, **{**KW, **opts})
    assert rec["status"] == "ok", rec.get("error")
    assert got["stats"] == rec["stats"]
    assert got["alias"] == rec["memory_analysis"]["alias_bytes"]
    assert got["stats"]["collective_bytes"] == 0
    assert got["stats"]["collective_count"] == 0


@pytest.mark.parametrize("arch", list(TRAIN_CELLS))
def test_train_cells_count_on_two_by_two(arch):
    """The SSM's chunked scan and the MoE's expert parallelism under
    DTensor, with the backward and AdamW: a count with products, bytes
    and collectives."""
    got = _fake_count(f"{arch}|train", arch=arch, params=None,
                      serve_quant=False, kv_quant=False)["stats"]
    assert got["flops"] > 0 and got["bytes_accessed"] > 0
    assert got["collective_bytes"] > 0
    assert got["argument_bytes"] > 0 and got["temp_bytes"] > 0
    if arch.startswith("moonshot"):
        one = _fake_count(f"{arch}|train", (1, 1), arch=arch, params=None,
                          serve_quant=False, kv_quant=False)["stats"]
        # the experts split over "model": fewer products a card
        assert got["flops_by_class"]["fp32_dot"] \
            + got["flops_by_class"]["bf16"] \
            < one["flops_by_class"]["fp32_dot"] + one["flops_by_class"][
                "bf16"]


def test_a_sharded_product_counts_its_local_flops_once():
    """DTensor runs ``mm`` once more at the global shapes to learn the
    output's placement; the counter sees only the local product."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from repro_torch.core.op_analysis import analyze_step
    with fake_process_mesh((2, 2), AXES) as mesh, FakeTensorMode():
        a = distribute_tensor(torch.empty(64, 256), mesh,
                              [Shard(0), Replicate()])
        b = distribute_tensor(torch.empty(256, 512), mesh,
                              [Replicate(), Shard(1)])
        out, st = analyze_step(torch.mm, a, b)
        assert tuple(out.to_local().shape) == (32, 256)
    assert st.flops_by_class["fp32_dot"] == 2.0 * 32 * 256 * 256
    assert st.collectives.total_bytes == 0
    assert st.argument_bytes == (32 * 256 + 256 * 256) * 4
    assert st.output_bytes == 32 * 256 * 4



def test_w4a8_runs_on_local_shards():
    """W4A8-pow2 serving (``--mode w4a8_pow2``): the packed-weight kernel
    counted on each card's shards at (2, 2), and at (1, 1) the one-card
    count exactly."""
    opts = dict(serve_quant=True, kv_quant=False, mode="w4a8_pow2")
    got = _fake_count("pod_decode", params=None, **opts)["stats"]
    one = _fake_count("pod_decode", (1, 1), params=None, **opts)["stats"]
    with pytest.MonkeyPatch.context() as mp:
        _patch(mp)
        rec = dryrun.run_cell(ARCH, "pod_decode", out_dir=None,
                              **{**KW, **opts})
    assert one == rec["stats"]
    calls = one["by_kernel"]["w4a8_matmul"]["calls"]
    assert calls == 7 * reduced(get_config(ARCH)).n_layers
    assert got["by_kernel"]["w4a8_matmul"]["calls"] == calls
    # the batch split over "data", the columns or the contraction over
    # "model": a quarter of the products a card
    assert got["by_kernel"]["w4a8_matmul"]["flops"] \
        == one["by_kernel"]["w4a8_matmul"]["flops"] / 4


def _chip_smoke():
    import importlib.util
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("index", [0, 1, 2])
def test_pod_collectives_equal_the_pinned_counts(index):
    """The ``pod_count`` phase's serving cells at full width on the
    fake-group pod meshes: their collectives a card equal the ones
    ``chip_smoke.POD_COUNT`` pins, which the phase holds the card's
    machine to under its own torch version (the port chooses each
    redistribution, not DTensor's version-dependent strategies)."""
    smoke = _chip_smoke()
    shape, kw, multi_pod, kvs = smoke.POD_COUNT["pods"][index]
    rec = dryrun.run_pod_cell(smoke.POD_COUNT["arch"], shape, out_dir=None,
                              multi_pod=multi_pod, kv_seq_shard=kvs,
                              count=True, **smoke._pod_options(kw))
    assert rec["status"] == "ok", rec.get("error")
    assert rec["torch"] == torch.__version__
    got = ({k: round(v) for k, v in
            rec["stats"]["collective_bytes_by_kind"].items()},
           rec["stats"]["collective_count_by_kind"])
    assert got == smoke.POD_COUNT["collectives"][(shape, rec["mesh"])]


@pytest.mark.parametrize("case", list(GRAD_CASES))
def test_products_on_local_shards_have_the_unsharded_gradients(pod, case):
    """A product on local shards (``qlinear._matmul``) under autograd on
    the 4 gloo ranks: the output and every input's gradient equal the
    unsharded float64 autograd's up to summation order.  An input whole
    on a mesh dim that the product splits (the weights over "data" while
    the rows are split there) gets a ``Partial`` gradient, which its
    move's backward reduce-scatters; taken as replicated, the gradients
    part by ~0.7 of their scale."""
    x, w1, w2 = (t.requires_grad_(True) for t in _grad_inputs())
    y = torch.tanh(x @ w1) @ w2
    (y * y).sum().backward()
    got = pod["outs"]["grads"][case]
    for g, want in zip(got, (y.detach(), x.grad, w1.grad, w2.grad)):
        assert g.shape == want.shape
        assert float((g - want).abs().max()) \
            <= 1e-12 * float(want.abs().max())


def test_propagation_is_quieted_only_for_dtensor_steps(monkeypatch):
    """A count of plain tensors leaves DTensor's internals alone; a torch
    without a name the quieting replaces fails loudly instead of
    counting each product again at its global shape."""
    from torch.distributed import _functional_collectives as fc
    from repro_torch.core import op_analysis as oa
    seen = []

    def step(a, b):
        seen.append(bool(oa._QUIET))
        return a @ b
    oa.analyze_step(step, torch.ones(4, 4), torch.ones(4, 4))
    assert seen == [False]
    monkeypatch.delattr(fc, "_are_we_tracing")
    with pytest.raises(RuntimeError, match="_are_we_tracing"):
        with oa.quiet_sharding_propagation():
            pass
    assert not oa._QUIET
