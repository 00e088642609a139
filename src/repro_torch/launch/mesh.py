"""Meshes over ``torch.distributed`` ranks: the port of
:mod:`repro.launch.mesh`.

The reference lays a ``jax.sharding.Mesh`` over the devices one process
sees; the port lays a :class:`~torch.distributed.device_mesh.DeviceMesh`
over the ranks of the default process group, one card per rank under
NCCL (``torchrun --nproc-per-node N``).  Functions, not module constants,
so importing touches no process group.

* When ``torch.distributed`` is already initialized (``torchrun``), a
  mesh spans its world.  When it is not, the first mesh starts a one-rank
  group on a :class:`~torch.distributed.HashStore` (NCCL for ``"cuda"``,
  gloo for ``"cpu"``); :func:`release_process_group` tears that group
  down again and leaves any other alone.
* ``device_type`` defaults to ``"cuda"`` and raises on a host without
  it: a CUDA mesh never becomes a CPU one.
* :func:`make_production_mesh` returns a :class:`ShapeMesh`, axis names
  and sizes without ranks (no machine here has 256), which the sharding
  rules read wherever the reference takes its pod mesh.
  :func:`fake_production_mesh` gives a real ``DeviceMesh`` of that shape
  over a ``fake`` process group of 256 / 512 ranks, on which the dry run
  counts a sharded step as rank 0 sees it (collectives return at once,
  moving nothing).

The reference's ``compat_make_mesh`` and ``compat_shard_map`` paper over
jax versions and have no torch counterpart: a sharded sweep takes its
rank's slice of the config axis and :func:`all_gather_group` assembles
the result (:mod:`repro_torch.core.dse_batch`), which replaces the
``shard_map`` over the ``"configs"`` axis.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math

import torch
import torch.distributed as dist

from repro_torch.core.device import resolve_device

# True while the default group is the one-rank group started here
_OWN_GROUP = False


@dataclasses.dataclass(frozen=True)
class ShapeMesh:
    """A mesh's axis names and sizes with no ranks behind it: what the
    rule tables (:mod:`repro_torch.parallel.sharding`) and the dry run
    read of a mesh, as the reference's tests read a ``FakeMesh``."""

    shape: tuple
    mesh_dim_names: tuple

    def size(self) -> int:
        return math.prod(self.shape)


def ensure_process_group(device_type: str = "cuda") -> None:
    """Refuse a device type the mesh cannot have (``"cuda"`` on a host
    without a card too), then start a one-rank default group (NCCL for
    ``"cuda"``, gloo for ``"cpu"``) on a ``HashStore`` unless one is
    initialized."""
    global _OWN_GROUP
    if device_type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported mesh device_type {device_type!r}: "
                         f"'cuda' or 'cpu'")
    dev = resolve_device(device_type)     # raises for CUDA without a card
    if dist.is_initialized():
        return
    if device_type == "cuda":
        dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                                world_size=1, device_id=dev)
    else:
        dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                                world_size=1)
    _OWN_GROUP = True


def release_process_group() -> None:
    """Destroy the one-rank group :func:`ensure_process_group` started,
    if it is still the default group; any other group stays."""
    global _OWN_GROUP
    if _OWN_GROUP and dist.is_initialized():
        dist.destroy_process_group()
    _OWN_GROUP = False


def device_mesh(device_type: str, ranks, axis_names: tuple):
    """A :class:`DeviceMesh` over ``ranks`` (an array of the mesh's
    shape, ranks of the default group).  Every rank of the group calls
    it, also one outside ``ranks``: building a mesh starts its
    sub-groups, a collective call."""
    from torch.distributed.device_mesh import DeviceMesh
    ensure_process_group(device_type)
    return DeviceMesh(device_type, torch.as_tensor(ranks, dtype=torch.int64),
                      mesh_dim_names=tuple(axis_names))


def make_production_mesh(*, multi_pod: bool = False) -> ShapeMesh:
    """The reference's pod meshes: 16 x 16 ``("data", "model")``, or
    2 x 16 x 16 ``("pod", "data", "model")`` with ``multi_pod``."""
    if multi_pod:
        return ShapeMesh((2, 16, 16), ("pod", "data", "model"))
    return ShapeMesh((16, 16), ("data", "model"))


@contextlib.contextmanager
def fake_process_mesh(shape: tuple, axis_names: tuple,
                      device_type: str = "cpu"):
    """A ``DeviceMesh`` of ``shape`` over a ``fake`` process group of
    ``prod(shape)`` ranks in which this process is rank 0: every
    collective returns at once without moving data, so a step on it runs
    (on fake or real tensors) as rank 0 of the mesh would, and the op
    counter sees its collectives at their real operand sizes.  The group
    is destroyed on exit.  Refused while a default group is up: a fake
    group must never stand where a real one is expected, nor a real one
    be torn down under its users."""
    from torch.distributed.device_mesh import DeviceMesh
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError(
            "a fake process group cannot start while a default group is up "
            f"({dist.get_backend()}, {dist.get_world_size()} ranks); "
            "release it first (release_process_group)")
    n = math.prod(shape)
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)
    try:
        yield DeviceMesh(device_type,
                         torch.arange(n, dtype=torch.int64).reshape(shape),
                         mesh_dim_names=tuple(axis_names))
    finally:
        dist.destroy_process_group()


def fake_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cpu"):
    """:func:`fake_process_mesh` of the reference's pod mesh
    (:func:`make_production_mesh`): 16 x 16 ``("data", "model")``, or
    2 x 16 x 16 ``("pod", "data", "model")``."""
    shape = make_production_mesh(multi_pod=multi_pod)
    return fake_process_mesh(shape.shape, shape.mesh_dim_names, device_type)


def make_host_mesh(model: int = 1, *, device_type: str = "cuda"):
    """A ``("data", "model")`` mesh over every rank of the group, the
    model axis the largest divisor of the world size not above
    ``model``."""
    ensure_process_group(device_type)
    n = dist.get_world_size()
    model = max(1, min(model, n))
    while n % model != 0:
        model -= 1
    return device_mesh(device_type,
                       torch.arange(n).reshape(n // model, model),
                       ("data", "model"))


def make_sweep_mesh(max_devices: int | None = None, *,
                    device_type: str = "cuda"):
    """A 1-D ``("configs",)`` mesh over every rank of the group (or the
    first ``max_devices``) for sharding a sweep's config axis:
    ``run(ExploreSpec...(mesh=...))`` and the ``_sweep_*`` engines of
    :mod:`repro_torch.core.dse_batch`."""
    ensure_process_group(device_type)
    n = dist.get_world_size()
    if max_devices is not None:
        n = max(1, min(n, int(max_devices)))
    return device_mesh(device_type, torch.arange(n), ("configs",))


def mesh_shards(mesh) -> int:
    """Config-axis shards a ``mesh=`` argument implies: ``None`` -> 1, an
    int (the CPU route's simulated shard count) -> itself, a mesh -> its
    size.  Delegates to the sweep engine, so padding and splitting have
    one source of truth."""
    from repro_torch.core.dse_batch import _mesh_shards
    return _mesh_shards(mesh)


def mesh_sizes(mesh) -> dict:
    """``{axis name: size}`` of a mesh or a :class:`ShapeMesh`."""
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


def stage(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` where ``group``'s backend can take it: a CUDA tensor goes
    through host memory for a gloo group (its collectives on CUDA
    tensors are not all documented), and stays on the card for NCCL."""
    if t.is_cuda and dist.get_backend(group) == "gloo":
        return t.cpu()
    return t


def _one_rank_under_grad(t: torch.Tensor, group) -> bool:
    """Whether a collective on ``t`` is the identity autograd can pass:
    one rank.  Collectives of several ranks under autograd are refused
    (the train step's gradients across ranks are not ported)."""
    if not (t.requires_grad and torch.is_grad_enabled()):
        return False
    if dist.get_world_size(group) > 1:
        raise NotImplementedError(
            "a collective of several ranks under autograd: training across "
            "ranks is not ported (ROADMAP A.4)")
    return True


def all_gather_group(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """Every rank of ``group``'s ``t`` concatenated along ``dim`` in
    group-rank order, on ``t``'s device (under autograd one rank's
    ``t`` itself)."""
    if _one_rank_under_grad(t, group):
        return t
    src = stage(t.contiguous(), group)
    parts = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts, dim=dim).to(t.device)


def all_reduce_sum(t: torch.Tensor, group) -> torch.Tensor:
    """The sum of every rank of ``group``'s ``t``, on ``t``'s device
    (under autograd one rank's ``t`` itself)."""
    if _one_rank_under_grad(t, group):
        return t
    out = stage(t, group).clone()
    dist.all_reduce(out, group=group)
    return out.to(t.device)
