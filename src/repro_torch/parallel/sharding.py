"""Sharding rules on ``torch.distributed``: FSDP over "data", TP over
"model", SP for activations, EP for experts, pure DP over "pod".

The port of :mod:`repro.parallel.sharding`.  The rule tables are the
reference's, read off a mesh's axis names and sizes only: a
:class:`~torch.distributed.device_mesh.DeviceMesh` or a shape-only
:class:`repro_torch.launch.mesh.ShapeMesh`.  A spec is a :class:`P`, a
``PartitionSpec``-like tuple with one entry per *tensor* dim: an axis
name, a tuple of names (major to minor) or ``None``.  A ``DTensor``
places per *mesh* dim instead; :func:`to_placements` converts.

Models stay pure: they call :func:`shard` with a *logical* name.  Inside
:func:`activation_sharding` a ``DTensor`` is redistributed to the rule's
placements; a plain tensor, and anything outside the context, passes
through.  Like ``with_sharding_constraint`` it never changes a value.
"""

from __future__ import annotations

import contextlib
import math
import threading

import torch

from repro_torch.launch.mesh import mesh_sizes

_state = threading.local()


class P(tuple):
    """A ``PartitionSpec``: ``P("data", None, ("pod", "data"))``.  Entries
    are normalized as ``jax.sharding.PartitionSpec`` normalizes them: a
    one-name tuple is that name, an empty one ``None``."""

    def __new__(cls, *entries):
        def entry(e):
            if isinstance(e, (tuple, list)):
                e = tuple(e)
                return None if not e else e[0] if len(e) == 1 else e
            return e
        return super().__new__(cls, tuple(entry(e) for e in entries))

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}" if len(self) != 1 \
            else f"P({self[0]!r})"


def _rules():
    return getattr(_state, "rules", None)


def _mesh():
    return getattr(_state, "mesh", None)


@contextlib.contextmanager
def activation_sharding(mesh, rules: dict):
    """Place the logical activation names of :func:`shard` on ``mesh``."""
    prev = (_rules(), _mesh())
    _state.rules, _state.mesh = rules, mesh
    try:
        yield
    finally:
        _state.rules, _state.mesh = prev


def shard(x, name: str):
    """Redistribute a ``DTensor`` ``x`` to the placements of the logical
    ``name``, if a context is active; the identity otherwise."""
    rules, mesh = _rules(), _mesh()
    if rules is None or mesh is None or rules.get(name) is None:
        return x
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    return x.redistribute(x.device_mesh,
                          to_placements(rules[name], x.device_mesh))


def reduce_partial(x):
    """A ``DTensor`` ``x`` with its ``Partial`` sums or maxima
    all-reduced here, not in whatever collective the first op that reads
    it would pick (DTensor's pick moves with the torch version); any
    other tensor as it is."""
    placements = getattr(x, "placements", None)
    if placements is None or not any(p.is_partial() for p in placements):
        return x
    from torch.distributed.tensor import Replicate
    return x.redistribute(x.device_mesh, [
        Replicate() if p.is_partial() else p for p in placements])


def einsum(equation: str, *operands):
    """``torch.einsum(equation, *operands)``; on ``DTensor`` operands run
    on each card's shards (``kernels/ops.on_local_shards``): the index
    letters of the output split over ranks where an operand is split on
    them, a split contracted letter summed by an all-reduce here.  The
    placements are the port's, not DTensor's einsum strategy, whose
    flattening of split dims some torch versions refuse."""
    from repro_torch.kernels.ops import on_local_shards, sharded
    if not sharded(*operands):
        return torch.einsum(equation, *operands)
    ins, out = equation.replace(" ", "").split("->")
    terms = ins.split(",")
    summed = tuple(sorted(set(ins) - set(out) - {","}))
    return reduce_partial(on_local_shards(
        lambda *t: torch.einsum(equation, *t), operands,
        tuple(tuple(t) for t in terms), tuple(out), split=tuple(out),
        sums=summed))


def placed_like(value, like):
    """``value`` moved to ``like``'s placements where both are
    ``DTensor``s, before a write into ``like`` (the port's move: the
    write's own would move with the torch version, and may gather the
    destination); any other ``value`` as it is."""
    have = getattr(value, "placements", None)
    want = getattr(like, "placements", None)
    if have is None or want is None or list(have) == list(want):
        return value
    return value.redistribute(like.device_mesh, want)


def gather_dim(x, dim: int):
    """A ``DTensor`` ``x`` with dim ``dim`` whole on every rank (its
    all-gathers counted); any other tensor as it is."""
    placements = getattr(x, "placements", None)
    if placements is None:
        return x
    from torch.distributed.tensor import Replicate
    dim %= x.dim()
    new = [Replicate() if p.is_shard(dim) else p for p in placements]
    return x if new == list(placements) else \
        x.redistribute(x.device_mesh, new)


def _viewable(old, new, d: int, n: int) -> bool:
    """Whether dim ``d`` of ``old``, split over ``n`` ranks, stays one
    ``Shard`` in the view to ``new``: kept whole, cut into dims whose
    outer one ``n`` divides, or merged with the dims after it as their
    outer part.  A dim its ranks do not divide evenly never stays."""
    if old[d] % n:
        return False
    pre = math.prod(old[:d])
    for j in range(len(new)):
        if math.prod(new[:j]) != pre:
            continue
        for k in range(j + 1, len(new) + 1):
            size = math.prod(new[j:k])
            if size == old[d]:
                outer = next((m for m in new[j:k] if m != 1), 1)
                return outer % n == 0
            if size > old[d]:
                break
        if any(math.prod(old[d:e]) == new[j]
               for e in range(d + 2, len(old) + 1)):
            return True
    return False


def _gathering_reshape(x, shape):
    from torch.distributed.tensor import DTensor, Replicate
    if not isinstance(x, DTensor):
        return x.reshape(*shape)
    shape = tuple(shape)
    if -1 in shape:
        i = shape.index(-1)
        rest = math.prod(shape[:i] + shape[i + 1:])
        shape = shape[:i] + (x.numel() // rest,) + shape[i + 1:]
    old = tuple(x.shape)
    ranks: dict = {}
    for i, p in enumerate(x.placements):
        if p.is_shard():
            ranks[p.dim] = ranks.get(p.dim, 1) * x.device_mesh.size(i)
    placements = [Replicate() if p.is_shard() and not _viewable(
        old, shape, p.dim, ranks[p.dim]) else p for p in x.placements]
    if placements != list(x.placements):
        x = x.redistribute(x.device_mesh, placements)
    return x.reshape(*shape)


class _Reshape(torch.autograd.Function):
    """The gathering reshape, and its inverse for the gradient."""

    @staticmethod
    def forward(ctx, x, shape):
        ctx.in_shape = tuple(x.shape)
        return _gathering_reshape(x, shape)

    @staticmethod
    def backward(ctx, grad):
        return _gathering_reshape(grad, ctx.in_shape), None


def reshape(x, *shape):
    """``x.reshape(*shape)``.  A ``DTensor`` split on a dim that the
    reshape merges into another or cuts into parts its ranks do not
    divide (24 heads of a 3072 wide projection over 16 ranks) has that
    dim gathered first (the all-gathers counted); a dim kept whole, or
    cut with its outer part divided by the ranks, stays split.  The rule
    is the port's, not DTensor's view propagation, whose choice moves
    with the torch version.  Its gradient takes the inverse reshape the
    same way (the heads merged in the forward are split in the
    backward)."""
    from repro_torch.kernels.ops import sharded
    if not sharded(x):
        return x.reshape(*shape)
    if x.requires_grad and torch.is_grad_enabled():
        return _Reshape.apply(x, tuple(shape))
    return _gathering_reshape(x, tuple(shape))


def data_axes(mesh) -> tuple[str, ...]:
    """Batch axes: ("pod","data") on the multi-pod mesh, else ("data",)."""
    return tuple(a for a in ("pod", "data") if a in mesh.mesh_dim_names)


def default_activation_rules(mesh, *, seq_sharded: bool,
                             batch_1: bool = False) -> dict:
    """Logical-name -> :class:`P` table.

    * residual: (batch -> data axes, seq -> model [SP], d_model replicated)
    * attn_heads / ffn_hidden: model-parallel inner dims
    * kv_cache: batch -> data (or seq -> data when batch==1, long-context)
    """
    d = data_axes(mesh)
    db = d if not batch_1 else (None,)
    sp = "model" if seq_sharded else None
    return {
        "residual": P(db, sp, None),
        "logits": P(db, sp, None),
        "attn_qkv": P(db, None, "model", None),       # (b, s, heads, hd)
        "ffn_hidden": P(db, None, "model"),           # (b, s, ff)
        "moe_buffer": P("model", None, None),         # (E, C, d)
        "kv_cache": P(db, None, None, None) if not batch_1
        else P(None, ("data",) if "data" in mesh.mesh_dim_names else None,
               None, None),                           # (b, S, kvh, hd)
        "ssm_state": P(db, "model", None, None),      # (b, heads, p, n)
    }


# ---------------------------------------------------------------------------
# Parameter shardings (FSDP over "data" + TP over "model")
# ---------------------------------------------------------------------------

_PARAM_RULES: list[tuple[tuple[str, ...], P]] = [
    # name-suffix patterns -> spec for the *logical* (unstacked) dims.
    # Stacked layer params get a leading None for the layer dim.
    (("embed",), P("model", "data")),                 # (V, d): vocab TP
    (("router",), P("data", "model")),                # (d, E)
    (("w_experts_in",), P("model", "data", None)),    # (E, d, ff): EP
    (("w_experts_gate",), P("model", "data", None)),
    (("w_experts_out",), P("model", None, "data")),   # (E, ff, d)
    (("wq",), P("data", "model")),                    # (d, H*hd): head TP
    (("wk",), P("data", "model")),
    (("wv",), P("data", "model")),
    (("wo",), P("model", "data")),                    # (H*hd, d)
    (("w_gate",), P("data", "model")),                # (d, ff): TP
    (("w_up",), P("data", "model")),
    (("w_down",), P("model", "data")),                # (ff, d)
    (("in_proj",), P("data", "model")),               # mamba (d, inner)
    (("out_proj",), P("model", "data")),
    (("wq_x",), P("data", "model")),                  # cross-attn
    (("wk_img",), P("data", "model")),
    (("wv_img",), P("data", "model")),
    (("wo_x",), P("model", "data")),
    (("conv_w", "dt_bias", "a_log", "d_skip", "ln1", "ln2", "ln_x",
      "final_norm"), P()),                            # small: replicate
]


def _axis_size(mesh, axis) -> int:
    if mesh is None or axis is None:
        return 1
    if isinstance(axis, (tuple, list)):
        n = 1
        for a in axis:
            n *= _axis_size(mesh, a)
        return n
    return mesh_sizes(mesh).get(axis, 1)


def param_pspec(path: str, shape: tuple, stacked: bool,
                mesh=None) -> P:
    """Sharding spec for one parameter leaf.

    ``path`` is the '/'-joined tree path; ``stacked`` marks per-layer
    stacked params (leading dim = layers, never sharded).  Any axis whose
    dim is not divisible by the mesh axis size is dropped (replicated) —
    e.g. mamba2's vocab 50280 is not 16-divisible, so it FSDP-shards
    d_model instead of TP-sharding the vocab.
    """
    rank = len(shape) - (1 if stacked else 0)
    dims = shape[1:] if stacked else shape

    def fit(spec_dims):
        out = []
        for i in range(rank):
            ax = spec_dims[i] if i < len(spec_dims) else None
            if ax is not None and dims[i] % _axis_size(mesh, ax) != 0:
                ax = None
            out.append(ax)
        return P(*([None] + out)) if stacked else P(*out)

    for pats, spec in _PARAM_RULES:
        if any(path.endswith(p) or f"/{p}" in path for p in pats):
            return fit(list(spec))
    if rank >= 2:  # default: FSDP-shard the first unstacked dim
        return fit(["data"] + [None] * (rank - 1))
    return P(*([None] * len(shape)))


def _spec_of(parts, per_layer, leaf, mesh):
    if not isinstance(leaf, torch.Tensor):
        return None                      # a host scalar: not placed
    name = "/".join(parts)
    # the reference's stacked test, for leaves the port keeps stacked
    stacked = not per_layer and ("layers/" in name
                                 or name.startswith("layers"))
    return param_pspec(name, tuple(leaf.shape), stacked, mesh)


def _walk(fn, t, prefix=(), per_layer=False):
    """``t`` rebuilt with ``fn(path parts, per_layer, leaf)`` at each leaf.
    A list holds one dict per layer (the port's unstacked layers): its
    index is no part of the rule path, and its leaves are per-layer.  A
    ``QuantizedTensor`` becomes ``{"data", "scale"}``."""
    from repro_torch.quant.qlinear import QuantizedTensor
    if isinstance(t, dict):
        return {k: _walk(fn, v, prefix + (str(k),), per_layer)
                for k, v in t.items()}
    if isinstance(t, list):
        return [_walk(fn, x, prefix, True) for x in t]
    if isinstance(t, QuantizedTensor):
        return {"data": fn(prefix + ("data",), per_layer, t.data),
                "scale": fn(prefix + ("scale",), per_layer, t.scale)}
    if isinstance(t, tuple) and hasattr(t, "_fields"):
        return type(t)(*(_walk(fn, getattr(t, f), prefix + (f,), per_layer)
                         for f in t._fields))
    if isinstance(t, tuple):
        return tuple(_walk(fn, x, prefix, per_layer) for x in t)
    return fn(prefix, per_layer, t)


def tree_pspecs(params, mesh=None):
    """A tree of :class:`P` matching ``params`` (dicts, lists of
    per-layer dicts, NamedTuples; a ``QuantizedTensor`` becomes
    ``{"data", "scale"}``); a leaf that is no tensor gets ``None``.  A
    per-layer leaf's spec is the reference's stacked one without its
    leading ``None``."""
    return _walk(lambda parts, per_layer, leaf:
                 _spec_of(parts, per_layer, leaf, mesh), params)


def leaf_specs(params, mesh=None) -> list:
    """``[(tensor, spec)]`` over the tensor leaves of ``params`` in
    :func:`tree_pspecs`' order and with its specs."""
    out = []

    def visit(parts, per_layer, leaf):
        spec = _spec_of(parts, per_layer, leaf, mesh)
        if spec is not None:
            out.append((leaf, spec))
    _walk(visit, params)
    return out


def to_placements(spec, mesh) -> list:
    """``spec`` (one entry per tensor dim) as ``DTensor`` placements (one
    per mesh dim): ``Shard(d)`` on each mesh dim that names tensor dim
    ``d``, ``Replicate()`` on the others.  A tuple entry shards one tensor
    dim over several mesh dims, major to minor, which must be the mesh's
    own order (DTensor splits over mesh dims left to right)."""
    from torch.distributed.tensor import Replicate, Shard
    names = tuple(mesh.mesh_dim_names)
    place = [Replicate() for _ in names]
    for d, entry in enumerate(tuple(spec)):
        if entry is None:
            continue
        axes = tuple(entry) if isinstance(entry, (tuple, list)) \
            else (entry,)
        idx = []
        for a in axes:
            if a is None:
                continue
            if a not in names:
                raise ValueError(f"spec {spec!r} names axis {a!r}, not an "
                                 f"axis of the mesh {names}")
            i = names.index(a)
            if not isinstance(place[i], Replicate):
                raise ValueError(f"spec {spec!r} uses mesh axis {a!r} "
                                 f"twice")
            place[i] = Shard(d)
            idx.append(i)
        if idx != sorted(idx):
            raise ValueError(
                f"spec {spec!r} orders axes {axes} against the mesh's "
                f"{names}; a DTensor shards over mesh dims in mesh order")
    return place


def _placed(spec, mesh) -> list:
    """:func:`to_placements` with every mesh dim of one rank
    ``Replicate``: a shard of one rank is the whole tensor, and DTensor
    refuses views of a dim it thinks split."""
    from torch.distributed.tensor import Replicate
    return [Replicate() if mesh.size(i) == 1 else p
            for i, p in enumerate(to_placements(spec, mesh))]


def local_shape(shape: tuple, spec, mesh) -> tuple:
    """The shape of one rank's shard of a ``shape`` tensor under
    ``spec`` (every named axis divides its dim, as :func:`param_pspec`
    and the dry run's ``_fit`` see to)."""
    out = list(shape)
    for d, entry in enumerate(tuple(spec)):
        n = _axis_size(mesh, entry)
        if out[d] % n:
            raise ValueError(f"dim {d} of {shape} does not divide over "
                             f"{entry!r} ({n} ranks)")
        out[d] //= n
    return tuple(out)


def distribute(x: torch.Tensor, mesh, spec):
    """``x`` (the same full tensor on every rank of ``mesh``) as a
    ``DTensor`` under ``spec``."""
    from torch.distributed.tensor import distribute_tensor
    return distribute_tensor(x, mesh, to_placements(spec, mesh))


def local_block(x: torch.Tensor, mesh, spec) -> torch.Tensor:
    """This rank's block of ``x`` under ``spec`` on ``mesh``: each
    sharded dim cut to the rank's part, the mesh axes of a tuple entry
    major to minor (``DTensor``'s order); a copy where it is cut."""
    names = tuple(mesh.mesh_dim_names)
    coord = mesh.get_coordinate()
    out = x
    for d, entry in enumerate(tuple(spec)):
        axes = tuple(entry) if isinstance(entry, (tuple, list)) \
            else (entry,)
        n, idx = 1, 0
        for a in axes:
            if a is None:
                continue
            i = names.index(a)
            idx = idx * mesh.size(i) + coord[i]
            n *= mesh.size(i)
        if n > 1:
            size = x.shape[d] // n
            out = out.narrow(d, idx * size, size)
    return out if out is x else out.clone()


def place(x: torch.Tensor, mesh, spec):
    """``x`` (the same full tensor on every rank) as a ``DTensor`` under
    ``spec``, each rank keeping its own block: :func:`distribute` without
    the scatter, so a fake process group places real shapes."""
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(local_block(x, mesh, spec), mesh,
                              _placed(spec, mesh), run_check=False,
                              shape=x.shape, stride=x.stride())


def place_tree(mesh, tree, put):
    """``tree`` with every tensor leaf ``put(leaf, spec)`` under
    :func:`tree_pspecs`' spec on ``mesh`` (a quantized weight's ``data``
    and ``scale`` each); host scalars stay."""
    from repro_torch.quant.qlinear import QuantizedTensor

    def place(t, s):
        if isinstance(t, dict):
            return {k: place(v, s[k]) for k, v in t.items()}
        if isinstance(t, list):
            return [place(x, y) for x, y in zip(t, s)]
        if isinstance(t, QuantizedTensor):
            return QuantizedTensor(put(t.data, s["data"]),
                                   put(t.scale, s["scale"]),
                                   t.mode, t.orig_shape)
        if isinstance(t, tuple) and hasattr(t, "_fields"):
            return type(t)(*(place(a, b) for a, b in zip(t, s)))
        if isinstance(t, tuple):
            return tuple(place(a, b) for a, b in zip(t, s))
        return t if s is None else put(t, s)
    return place(tree, tree_pspecs(tree, mesh))


def tree_shardings(mesh, params):
    """``params`` (the same full tensors on every rank) with every tensor
    leaf a ``DTensor`` placed on ``mesh`` by :func:`tree_pspecs`, each
    rank keeping its own block (:func:`place`)."""
    return place_tree(mesh, params, lambda t, s: place(t, mesh, s))
