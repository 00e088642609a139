"""Checkpoint save/restore: step-indexed, checksummed, rotated.

Port of :mod:`repro.checkpoint.checkpoint`, which the training loop
(:func:`repro_torch.runtime.fault_tolerance.run_with_restarts`) and the
exploration runtime (:mod:`repro_torch.runtime.dse_checkpoint`) stand on:

* checkpoints are atomic (write to tmp, fsync, rename);
* every checkpoint carries a content checksum; restore skips corrupt ones
  and falls back to the newest valid one;
* the data cursor (the step) and the whole train state are in the
  checkpoint, so a restart equals the uninterrupted run bit for bit.

Two snapshot formats share the directory layout (``step_<n>/arrays.npz``
+ ``meta.json``), the checksum rule and keep-N rotation, which are the
reference's, so a checkpoint written by either package restores in the
other:

* :func:`save` / :func:`restore` — tree checkpoints of a train state,
  leaves ``leaf_<i>`` in ``jax.tree_util``'s order
  (:func:`repro_torch.models.tree.tree_flatten`), restored into the
  structure, types, dtypes, shapes and **devices** of a ``like`` tree: a
  state the card wrote restores on the CPU and the other way round; a
  restored state goes onto a mesh of ranks with
  :func:`repro_torch.runtime.elastic.reshard`;
* a **placed** tree (``DTensor`` leaves, the state of a train step on a
  mesh of ranks): :func:`save` gathers each leaf whole on every rank (a
  collective each rank of the mesh makes), the rank at the mesh's
  origin writes the file layout an unplaced save writes (same leaves,
  dtypes and shapes) into a directory every rank reads, and every rank
  then meets it at a barrier, so the newest valid step is the same for
  all; :func:`restore` into a placed ``like`` cuts each rank's block
  from the whole leaf, placed as ``like``'s.  A checkpoint of several
  ranks restores into an unplaced state on one process, and the other
  way round;
* :func:`save_state` / :func:`restore_state` — self-describing nested
  dicts of arrays and scalars whose shapes grow between snapshots (a
  Pareto front, a synthesis cache), with no ``like`` structure at restore
  time; array dtype and shape round-trip exactly.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil

import numpy as np
import torch

from repro_torch.models.tree import tree_flatten
from repro_torch.parallel.sharding import place_as


def _rotate(ckpt_dir: str, keep: int):
    steps = sorted(d for d in os.listdir(ckpt_dir) if d.startswith("step_")
                   and not d.endswith(".tmp"))
    for d in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, d), ignore_errors=True)


def _valid(path: str) -> bool:
    try:
        with open(os.path.join(path, "meta.json")) as f:
            meta = json.load(f)
        with open(os.path.join(path, "arrays.npz"), "rb") as f:
            digest = hashlib.file_digest(f, "sha256").hexdigest()
        return digest == meta["sha256"]
    except Exception:
        return False


def latest_step(ckpt_dir: str) -> int | None:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = sorted(int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
                   if d.startswith("step_") and not d.endswith(".tmp"))
    for s in reversed(steps):
        if _valid(os.path.join(ckpt_dir, f"step_{s:08d}")):
            return s
    return None


def _mesh_of(leaves):
    """The ``DeviceMesh`` of the first placed leaf, or None."""
    return next((l.device_mesh for l in leaves
                 if hasattr(l, "device_mesh")), None)


def _mesh_barrier(mesh) -> None:
    """Return once every rank of ``mesh`` has come here: a one-element
    all-reduce over the mesh, read back on the host."""
    from torch.distributed.tensor import DTensor, Partial
    one = torch.zeros(1, device=mesh.device_type)
    float(DTensor.from_local(one, mesh, [Partial()] * mesh.ndim,
                             run_check=False).full_tensor()[0])


def _host_array(leaf, i: int) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        if hasattr(leaf, "full_tensor"):
            leaf = leaf.full_tensor()    # a collective on every rank
        if leaf.dtype == torch.bfloat16:
            raise TypeError(
                f"leaf {i} is bfloat16: the reference's restore cannot read "
                f"a bfloat16 leaf back (np.load gives '|V2', which does not "
                f"cast), so no such checkpoint is written (ROADMAP C.14)")
        return leaf.detach().cpu().numpy()
    if isinstance(leaf, (bool, int, float)):
        return np.asarray(leaf)
    raise TypeError(f"leaf {i} has unsupported type {type(leaf).__name__} "
                    f"(use a tensor, an int or a float)")


def _like(arr: np.ndarray, like):
    """``arr`` as a leaf of ``like``'s type, dtype, shape, device and
    placements."""
    if isinstance(like, torch.Tensor):
        return place_as(torch.from_numpy(np.ascontiguousarray(arr)).to(
            device=like.device, dtype=like.dtype).reshape(like.shape), like)
    return type(like)(arr.item())


def save(ckpt_dir: str, step: int, tree, *, keep: int = 3) -> str:
    """Atomically save ``tree`` as checkpoints/step_<n>/ and rotate.
    Tensors are copied to the host; host ints and floats are written as
    0-d arrays.  A placed tree: every rank of its mesh calls this; each
    leaf is gathered, the mesh's origin writes, and all meet after the
    publish."""
    leaves, treedef = tree_flatten(tree)
    arrs = {f"leaf_{i}": _host_array(l, i) for i, l in enumerate(leaves)}
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    mesh = _mesh_of(leaves)
    if mesh is None or not any(mesh.get_coordinate()):
        _write(ckpt_dir, path, step, arrs, len(leaves), treedef, keep)
    if mesh is not None:
        _mesh_barrier(mesh)
    return path


def _write(ckpt_dir, path, step, arrs, n_leaves, treedef, keep) -> None:
    os.makedirs(ckpt_dir, exist_ok=True)
    tmp = path + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    npz = os.path.join(tmp, "arrays.npz")
    with open(npz, "wb") as f:
        np.savez(f, **arrs)
        f.flush()
        os.fsync(f.fileno())
    with open(npz, "rb") as f:
        digest = hashlib.file_digest(f, "sha256").hexdigest()
    meta = {"step": step, "n_leaves": n_leaves, "sha256": digest,
            "treedef": str(treedef)}
    with open(os.path.join(tmp, "meta.json"), "w") as f:
        json.dump(meta, f)
    if os.path.exists(path):
        shutil.rmtree(path)      # a replayed step: replace it
    os.replace(tmp, path)                      # atomic publish
    _rotate(ckpt_dir, keep)


def restore(ckpt_dir: str, step: int, like):
    """Restore into the structure of ``like`` (validates checksum); each
    leaf takes the type, dtype, shape, device and placements of
    ``like``'s."""
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    if not _valid(path):
        raise IOError(f"checkpoint {path} is corrupt or missing")
    leaves, treedef = tree_flatten(like)
    with np.load(os.path.join(path, "arrays.npz")) as data:
        restored = [_like(data[f"leaf_{i}"], l)
                    for i, l in enumerate(leaves)]
    return treedef.unflatten(restored)


def restore_latest(ckpt_dir: str, like):
    s = latest_step(ckpt_dir)
    if s is None:
        return None, None
    return s, restore(ckpt_dir, s, like)


# ---------------------------------------------------------------------------
# Self-describing state snapshots (nested dicts, no `like` needed)
# ---------------------------------------------------------------------------

_PATH_SEP = "/"


def _flatten_state(state: dict, prefix: str = ""
                   ) -> tuple[dict[str, np.ndarray], dict[str, object]]:
    """Walk a nested dict: arrays by joined path, JSON scalars apart."""
    arrays: dict[str, np.ndarray] = {}
    scalars: dict[str, object] = {}
    for key, val in state.items():
        if not isinstance(key, str) or _PATH_SEP in key:
            raise ValueError(
                f"state keys must be '/'-free strings, got {key!r}")
        path = prefix + key
        if isinstance(val, dict):
            sub_a, sub_s = _flatten_state(val, path + _PATH_SEP)
            arrays.update(sub_a)
            scalars.update(sub_s)
        elif isinstance(val, np.ndarray):
            arrays[path] = val
        elif isinstance(val, (bool, int, float, str)) or val is None:
            scalars[path] = val
        elif isinstance(val, (np.integer, np.floating, np.bool_)):
            scalars[path] = val.item()
        else:
            raise TypeError(
                f"state leaf {path!r} has unsupported type "
                f"{type(val).__name__} (use np.ndarray, int, float, "
                f"bool, str, None, or a nested dict)")
    return arrays, scalars


def _unflatten_state(arrays: dict, scalars: dict) -> dict:
    state: dict = {}
    for path, val in list(arrays.items()) + list(scalars.items()):
        parts = path.split(_PATH_SEP)
        node = state
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val
    return state


def save_state(ckpt_dir: str, step: int, state: dict, *,
               keep: int = 3) -> str:
    """Atomically save a nested dict of arrays/scalars as
    checkpoints/step_<n>/ and rotate.

    The snapshot is self-describing: array dtypes, shapes, and the dict
    structure restore exactly with no ``like`` tree — required for
    exploration state whose arrays (Pareto front, synthesis cache rows)
    change shape between snapshots.  Same checksum validation and keep-N
    rotation as tree checkpoints; the two formats may share a directory.
    """
    arrays, scalars = _flatten_state(state)
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    if _valid(path):
        # re-saving a step re-serializes identical state (snapshots are
        # deterministic functions of the step); keep the durable copy
        return path
    if os.path.exists(path):
        shutil.rmtree(path)      # corrupt leftover: replace it
    tmp = path + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    npz = os.path.join(tmp, "arrays.npz")
    with open(npz, "wb") as f:
        np.savez(f, **arrays)
        f.flush()
        os.fsync(f.fileno())
    with open(npz, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()
    meta = {"step": step, "format": "state", "sha256": digest,
            "scalars": scalars, "array_paths": sorted(arrays)}
    with open(os.path.join(tmp, "meta.json"), "w") as f:
        json.dump(meta, f)
    os.replace(tmp, path)                      # atomic publish
    _rotate(ckpt_dir, keep)
    return path


def restore_state(ckpt_dir: str, step: int) -> dict:
    """Restore a :func:`save_state` snapshot (validates checksum)."""
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    if not _valid(path):
        raise IOError(f"checkpoint {path} is corrupt or missing")
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    if meta.get("format") != "state":
        raise IOError(
            f"checkpoint {path} is a pytree checkpoint, not a state "
            f"snapshot (use restore())")
    with np.load(os.path.join(path, "arrays.npz")) as z:
        arrays = {k: z[k] for k in meta["array_paths"]}
    return _unflatten_state(arrays, meta["scalars"])


def restore_latest_state(ckpt_dir: str) -> tuple[int | None, dict | None]:
    """``(step, state)`` of the newest *valid* state snapshot, or
    ``(None, None)``.  Corrupt or truncated snapshots are skipped, falling
    back to the next-newest valid one."""
    if not os.path.isdir(ckpt_dir):
        return None, None
    steps = sorted(int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
                   if d.startswith("step_") and not d.endswith(".tmp"))
    for s in reversed(steps):
        try:
            return s, restore_state(ckpt_dir, s)
        except Exception:
            continue
    return None, None
