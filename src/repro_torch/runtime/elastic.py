"""Elastic re-meshing: reshard a training state onto a different mesh.

The port of :mod:`repro.runtime.elastic`.  When the fleet shrinks or
grows (node failure, preemption, scale-up), the state must be laid out
for the new rank count.  Because parameter specs are *logical*
(:mod:`repro_torch.parallel.sharding`), resharding is a re-placement
under the specs the new mesh gives; the divisibility fallback of
``param_pspec`` handles axes that stop dividing evenly.  Restoring a
checkpoint onto one card stays :func:`repro_torch.checkpoint.checkpoint
.restore` with ``like`` there.
"""

from __future__ import annotations

import numpy as np

from repro_torch.launch.mesh import device_mesh
from repro_torch.parallel.sharding import (distribute, place_tree,
                                           to_placements)


def reshard(state, new_mesh):
    """``state`` with every tensor leaf a ``DTensor`` on ``new_mesh`` under
    the logical rules.  A plain leaf (the same full tensor on every rank)
    is distributed; a ``DTensor`` on ``new_mesh`` is redistributed, one
    on another mesh gathered whole over its own mesh (a collective there)
    and distributed anew.  Every rank of the old mesh calls it."""
    from torch.distributed.tensor import DTensor

    def put(x, spec):
        if isinstance(x, DTensor):
            if x.device_mesh == new_mesh:
                return x.redistribute(new_mesh,
                                      to_placements(spec, new_mesh))
            x = x.full_tensor()
        return distribute(x, new_mesh, spec)
    return place_tree(new_mesh, state, put)


def survivable_mesh(ranks, axis_names=("data", "model"),
                    prefer_model: int = 16, *, device_type: str = "cuda"):
    """The largest usable ``DeviceMesh`` over the surviving ``ranks``.

    Keeps the model axis at ``prefer_model`` if possible (the TP degree is
    a property of the program), halving it until it divides the count,
    and shrinks the data axis.  Every rank of the default group calls it,
    those outside the new mesh too (building its sub-groups is a
    collective call).
    """
    n = len(ranks)
    model = prefer_model
    while model > 1 and n % model != 0:
        model //= 2
    data = n // model
    grid = np.asarray(list(ranks)[:data * model]).reshape(data, model)
    return device_mesh(device_type, grid, tuple(axis_names))
