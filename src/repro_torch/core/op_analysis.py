"""Op-level cost model of one eager PyTorch step.

The port's counterpart of ``repro.core.hlo_analysis``.  The reference
parses optimized HLO text because XLA's ``cost_analysis`` counts a
``while`` body once.  PyTorch has no HLO: it runs eagerly, op by op, so
:class:`OpCounter`, a ``TorchDispatchMode``, sees every aten op with its
real shapes and dtypes, and a Python loop of layers is counted once per
layer with no trip counts to parse.  It sums

* FLOPs: a dot (``mm``, ``bmm``, ``addmm``, ``baddbmm``, ``_int_mm``) is
  2 * batch * M * N * K from the operand shapes, in the class of its
  operands' dtype (``int8``, ``bf16``, ``fp32_dot``; float64 in ``fp32``);
  a convolution or an SDPA op takes ``torch.utils.flop_counter``'s
  formula; an op tagged ``pointwise`` is 1 FLOP an output element, a
  reduction (tagged ``reduction``, or a softmax, scan, sort or top-k) 1 an
  input element, both in ``fp32`` (the CUDA cores).  Copies (``clone``,
  ``_to_copy``, ``copy_``) move bytes and do no FLOPs;
* transcendentals, one an output element of ``exp``, ``log``, ``tanh``,
  ``sigmoid``, ``pow``, ``expm1``, ``log1p``, ``sin``, ``cos`` and
  ``erf`` (the reference's list plus ``erf``) and one an input element
  of a softmax;
* bytes accessed: operand bytes plus result bytes at every op, since in
  eager mode every op is a fusion boundary (the reference's convention).
  Views and other free ops cost nothing (the reference's ``_FREE_OPS``);
  an in-place write into a slice (``copy_``, ``index_put_``, ``scatter_``:
  how the KV caches are written) costs twice the region it moves, the
  reference's dynamic-update-slice rule.  A broadcast operand (a zero
  stride) is read once;
* collectives: the operand bytes and the count of every
  ``_c10d_functional`` / ``c10d`` collective, under the reference's kinds
  (zero on one card).

The hand-written kernels launch through ctypes, which the dispatcher never
sees.  So each kernel's cost is declared beside it (``cost()`` in
``kernels/w8a8_matmul.py``, ``w4a8_matmul.py``, ``w8a8_decode.py``,
``flash_attention.py``) and ``kernels/ops.py`` opens a
:func:`kernel_scope` with it around every kernel entry, on whichever
route runs: inside the scope no aten op is counted and one kernel record
is added instead.  A step therefore counts the same work on the kernel
route on the card, on the plain route on the CPU and under fake tensors.
A backward has no kernel (ROADMAP C.13) and is counted op by op.

A step on ``DTensor`` arguments (a sharded step on a ``DeviceMesh``,
``launch/dryrun.run_pod_cell``) is counted on one card: the counter
declines a call on ``DTensor`` operands (``NotImplemented``), so the
``DTensor`` layer redistributes them (its collectives counted, on the
local shards) and runs the op on the local shards, which the counter
then sees.  DTensor's sharding propagation, which runs the op once more
at the global shapes to learn the output's, is kept out of the count
(:func:`quiet_sharding_propagation`).  Bytes, live bytes and the
argument and output bytes are the local shards'.

The counter also follows the bytes of the results it sees that are alive
(``weakref.finalize``); their peak is ``temp_bytes``, the counterpart of
XLA's ``temp_size``.  A kernel scope's intermediates are not followed,
only what it returns.

:class:`StepStats` is the counterpart of ``CompiledStats``.
``flop_counter_flops`` stands in for ``xla_flops``: what
``torch.utils.flop_counter.FlopCounterMode``'s formulas give for the
aten ops counted outside the kernel scopes (it cannot see a ctypes
kernel, so no kernel is in it, on any route; it has no formula for
``_int_mm``).  ``xla_bytes`` and ``generated_code_bytes`` have no
counterpart and are dropped.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import weakref

import torch
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _disable_current_modes)

#: aten collectives by the reference's kinds (``hlo_analysis._COLLECTIVES``)
_COLLECTIVE_KIND = {
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_reduce_coalesced_": "all-reduce",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "alltoall_": "all-to-all", "alltoall_base_": "all-to-all",
    "all_to_all_single": "all-to-all",
    "send": "collective-permute", "recv_": "collective-permute",
}
_COLLECTIVE_NAMESPACES = ("_c10d_functional", "c10d")

#: ops that move nothing (views, aliases, allocation without a fill)
_FREE_OPS = {
    "view", "_unsafe_view", "t", "transpose", "permute", "expand", "slice",
    "select", "unsqueeze", "squeeze", "alias", "detach", "split",
    "split_with_sizes", "unbind", "as_strided", "_reshape_alias",
    "view_as_real", "view_as_complex", "lift_fresh", "empty",
    "empty_strided", "empty_like", "wait_tensor", "_wrap_tensor_autograd",
    "barrier", "_local_scalar_dense", "sym_size", "sym_stride",
    "sym_numel", "sym_storage_offset", "is_same_size", "device",
}
#: copies: bytes, no FLOPs
_COPIES = {"clone", "_to_copy", "copy_", "copy"}
#: writes of a region of their first operand: twice the moved region
_SLICE_WRITES = {"copy_", "index_put_", "_index_put_impl_", "scatter_",
                 "index_copy_"}
#: reductions the tags do not mark: one FLOP an input element
_REDUCTIONS = {"_softmax", "_log_softmax", "_softmax_backward_data",
               "_log_softmax_backward_data", "cumsum", "cumprod",
               "logcumsumexp", "topk", "sort", "logsumexp"}
#: one transcendental an output element (a softmax: an input element)
_TRANSCENDENTALS = {"exp", "log", "tanh", "sigmoid", "pow", "expm1",
                    "log1p", "sin", "cos", "erf"}
_SOFTMAX = {"_softmax", "_log_softmax", "logsumexp"}
_DOTS = {"mm", "bmm", "addmm", "baddbmm", "_int_mm"}

_ACTIVE: list["OpCounter"] = []


def dot_class(dtype: torch.dtype) -> str:
    """The compute class of a product on operands of ``dtype``."""
    if dtype in (torch.int8, torch.uint8):
        return "int8"
    if dtype in (torch.bfloat16, torch.float16):
        return "bf16"
    if dtype == torch.float32:
        return "fp32_dot"
    return "fp32"


def tensor_bytes(t: torch.Tensor) -> int:
    """Bytes a read of ``t`` moves: each element once, a broadcast
    (zero-stride) dimension once."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride != 0:
            n *= size
    return n * t.element_size()


def _dot_flops(name: str, args) -> float:
    """2 * batch * M * N * K of a product, from its operand shapes."""
    if name in ("addmm", "baddbmm"):
        a, b = args[1], args[2]
    else:
        a, b = args[0], args[1]
    batch = a.shape[0] if a.dim() == 3 else 1
    return 2.0 * batch * a.shape[-2] * b.shape[-1] * a.shape[-1]


def _moved_region(name: str, args) -> int:
    """Bytes an in-place write into a region of ``args[0]`` moves: the
    written view (``copy_``), the values (``index_put_``, ``index_copy_``)
    or one element of ``args[0]`` an index (``scatter_``)."""
    if name == "copy_":
        return tensor_bytes(args[0])
    if name == "scatter_":
        return args[2].numel() * args[0].element_size()
    return tensor_bytes(args[3] if name == "index_copy_" else args[2])


@dataclasses.dataclass
class CollectiveStats:
    bytes_by_kind: dict[str, float]
    count_by_kind: dict[str, int]

    @property
    def total_bytes(self) -> float:
        return float(sum(self.bytes_by_kind.values()))

    @property
    def total_count(self) -> int:
        return int(sum(self.count_by_kind.values()))


@dataclasses.dataclass
class StepStats:
    """Everything the roofline needs about one step."""

    flops: float
    flops_by_class: dict[str, float]
    bytes_accessed: float
    transcendentals: float
    collectives: CollectiveStats
    by_kernel: dict[str, dict]     # name -> {"flops", "bytes", "calls"}
    flop_counter_flops: float      # FlopCounterMode's formulas, x-ref
    argument_bytes: int
    output_bytes: int
    temp_bytes: int

    def as_dict(self) -> dict:
        return {
            "flops": self.flops,
            "flops_by_class": dict(self.flops_by_class),
            "bytes_accessed": self.bytes_accessed,
            "transcendentals": self.transcendentals,
            "collective_bytes": self.collectives.total_bytes,
            "collective_count": self.collectives.total_count,
            "collective_bytes_by_kind": self.collectives.bytes_by_kind,
            "collective_count_by_kind": self.collectives.count_by_kind,
            "by_kernel": {k: dict(v) for k, v in self.by_kernel.items()},
            "flop_counter_flops": self.flop_counter_flops,
            "argument_bytes": self.argument_bytes,
            "output_bytes": self.output_bytes,
            "temp_bytes": self.temp_bytes,
        }


class OpCounter(TorchDispatchMode):
    """Counts the aten ops run while it is active (see the module
    docstring); :meth:`stats` gives the totals."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self._flop_registry = flop_registry
        self.flops_by_class = {"int8": 0.0, "bf16": 0.0, "fp32_dot": 0.0,
                               "fp32": 0.0}
        self.bytes_accessed = 0.0
        self.transcendentals = 0.0
        self.flop_counter_flops = 0.0
        self.coll_bytes: dict[str, float] = {}
        self.coll_count: dict[str, int] = {}
        self.by_kernel: dict[str, dict] = {}
        self._scopes = 0
        self.live_bytes = 0
        self.peak_bytes = 0

    def __enter__(self):
        _ACTIVE.append(self)
        self._quiet = contextlib.ExitStack()
        return super().__enter__()

    def __exit__(self, *exc):
        _ACTIVE.remove(self)
        try:
            return super().__exit__(*exc)
        finally:
            self._quiet.close()

    # ------------------------------------------------------------ kernels
    @contextlib.contextmanager
    def kernel_scope(self, name: str, flops: float, bytes_: float,
                     cls: str):
        """Count one call of kernel ``name`` as ``flops`` of class ``cls``
        moving ``bytes_``; no aten op inside is counted.  A scope inside
        another adds nothing: the outer one's cost is the work."""
        if self._scopes == 0:
            rec = self.by_kernel.setdefault(
                name, {"flops": 0.0, "bytes": 0.0, "calls": 0})
            rec["flops"] += flops
            rec["bytes"] += bytes_
            rec["calls"] += 1
            self.flops_by_class[cls] += flops
            self.bytes_accessed += bytes_
        self._scopes += 1
        try:
            yield
        finally:
            self._scopes -= 1

    def track(self, out) -> None:
        """Follow the bytes of ``out``'s tensors while they live (what a
        kernel scope returns)."""
        if self._scopes:
            return
        for t in leaves(out):
            self._follow(t._base if t._base is not None else t)

    def _follow(self, t: torch.Tensor) -> None:
        n = t.numel() * t.element_size()
        self.live_bytes += n
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        weakref.finalize(t, self._release, n)

    def _release(self, n: int) -> None:
        self.live_bytes -= n

    # ----------------------------------------------------------- aten ops
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if _dtensor_types(types):
            # the DTensor layer takes the call and runs it on the local
            # shards, which come back here; its propagation from the
            # first such call on runs quiet
            if not _QUIET:
                self._quiet.enter_context(quiet_sharding_propagation())
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self._scopes:
            return out
        name = func._overloadpacket.__name__
        if name in _FREE_OPS:
            return out
        ins = list(leaves((args, kwargs)))
        outs = list(leaves(out))
        if func.namespace in _COLLECTIVE_NAMESPACES:
            kind = _COLLECTIVE_KIND.get(name)
            if kind is not None:
                moved = sum(tensor_bytes(t) for t in ins)
                self.coll_bytes[kind] = self.coll_bytes.get(kind, 0.0) \
                    + moved
                self.coll_count[kind] = self.coll_count.get(kind, 0) + 1
                self.bytes_accessed += moved + sum(
                    tensor_bytes(t) for t in outs)
            return out
        if name in _SLICE_WRITES and outs and outs[0] is args[0]:
            self.bytes_accessed += 2 * _moved_region(name, args)
        else:
            self.bytes_accessed += sum(tensor_bytes(t) for t in ins) + sum(
                tensor_bytes(t) for t in outs)
        self._count_flops(func, name, args, kwargs, ins, outs, out)
        for t in outs:
            if t._base is None and not any(t is a for a in ins):
                self._follow(t)
        return out

    def _count_flops(self, func, name, args, kwargs, ins, outs, out):
        formula = self._flop_registry.get(func._overloadpacket)
        registered = 0 if formula is None \
            else formula(*args, **kwargs, out_val=out)
        self.flop_counter_flops += registered
        base = name.rstrip("_")
        out_elems = sum(t.numel() for t in outs)
        if name in _DOTS:
            a = args[1] if name in ("addmm", "baddbmm") else args[0]
            flops = _dot_flops(name, args)
            self.flops_by_class[dot_class(a.dtype)] += flops
            if name in ("addmm", "baddbmm"):     # the added term
                self.flops_by_class["fp32"] += out_elems
            return
        if formula is not None:                  # convolution, SDPA
            self.flops_by_class[dot_class(ins[0].dtype)] += registered
            return
        if name in _COPIES:
            return
        in_elems = ins[0].numel() if ins else 0
        if torch.Tag.reduction in func.tags or name in _REDUCTIONS:
            self.flops_by_class["fp32"] += in_elems
        elif torch.Tag.pointwise in func.tags:
            self.flops_by_class["fp32"] += out_elems
        if base in _TRANSCENDENTALS:
            self.transcendentals += out_elems
        elif name in _SOFTMAX:
            self.transcendentals += in_elems

    # -------------------------------------------------------------- totals
    def stats(self, *, argument_bytes: int = 0,
              output_bytes: int = 0) -> StepStats:
        by_class = dict(self.flops_by_class)
        return StepStats(
            flops=math.fsum(by_class.values()), flops_by_class=by_class,
            bytes_accessed=self.bytes_accessed,
            transcendentals=self.transcendentals,
            collectives=CollectiveStats(dict(self.coll_bytes),
                                        dict(self.coll_count)),
            by_kernel={k: dict(v) for k, v in self.by_kernel.items()},
            flop_counter_flops=self.flop_counter_flops,
            argument_bytes=argument_bytes, output_bytes=output_bytes,
            temp_bytes=self.peak_bytes)


def active() -> OpCounter | None:
    """The innermost active counter, or None."""
    return _ACTIVE[-1] if _ACTIVE else None


@contextlib.contextmanager
def kernel_scope(name: str, flops: float, bytes_: float, cls: str):
    """:meth:`OpCounter.kernel_scope` of the active counter; nothing
    without one."""
    counter = active()
    if counter is None:
        yield
        return
    with counter.kernel_scope(name, flops, bytes_, cls):
        yield


_DTENSOR: list = []


def _dtensor_class():
    """``DTensor`` where ``torch.distributed`` has it, else None."""
    if not _DTENSOR:
        cls = None
        if torch.distributed.is_available():
            from torch.distributed.tensor import DTensor as cls
        _DTENSOR.append(cls)
    return _DTENSOR[0]


def _dtensor_types(types) -> bool:
    cls = _dtensor_class()
    return cls is not None and any(issubclass(t, cls) for t in types)


def local(t: torch.Tensor) -> torch.Tensor:
    """One card's part of ``t``: a ``DTensor``'s local shard, else ``t``."""
    cls = _dtensor_class()
    return t._local_tensor if cls is not None and isinstance(t, cls) else t


def _modes_off(fn):
    def run(*args, **kwargs):
        with _disable_current_modes():
            return fn(*args, **kwargs)
    return run


def _fake_mode_unset(fn):
    def run():
        from torch._subclasses.fake_tensor import unset_fake_temporarily
        with unset_fake_temporarily():
            return fn()
    return run


@contextlib.contextmanager
def _wrapped(obj, name: str, wrap):
    """``obj.name`` replaced by ``wrap(obj.name)`` inside the context (a
    static method stays static).  Raises where ``obj`` has no ``name``:
    a torch without it would count the propagation run again."""
    if not hasattr(obj, name):
        raise RuntimeError(
            f"torch {torch.__version__}: {getattr(obj, '__name__', obj)!r} "
            f"has no {name!r}, which the count of a DTensor step quiets")
    own = name in vars(obj)
    old = vars(obj).get(name)
    new = wrap(getattr(obj, name))
    setattr(obj, name, staticmethod(new) if isinstance(old, staticmethod)
            else new)
    try:
        yield
    finally:
        if own:
            setattr(obj, name, old)
        else:
            delattr(obj, name)


#: set while :func:`quiet_sharding_propagation` is in force
_QUIET: list = []


@contextlib.contextmanager
def quiet_sharding_propagation():
    """Run DTensor's sharding propagation with every dispatch mode off.

    DTensor learns an op's output placement by running the op once more
    on fake tensors of the *global* shapes; an active counter would count
    that run beside the local one (a product about ``1 + 1 / chips``
    times).  Its strided-shard offsets also call ``tolist()`` on index
    tensors, which fails where they are built under a ``FakeTensorMode``.
    Both are bookkeeping on shapes, not work on the card: inside this
    context they run outside the modes (the counter, the dry run's fake
    mode).  DTensor also takes an active ``FakeTensorMode`` for a
    ``torch.compile`` trace and then caches no propagation, so each layer
    of a step would propagate every op anew: here an active fake mode
    alone does not count as tracing (``_are_we_tracing``, where it is
    defined and in every DTensor module that holds it).  A counter enters
    this at its first ``DTensor`` call, so a step on plain tensors runs
    none of it.  Raises where a name it replaces is missing; everything
    is restored on exit."""
    import sys

    from torch.distributed import _functional_collectives as fc
    from torch.distributed.tensor import DTensor, placement_types
    tracing = getattr(fc, "_are_we_tracing", None)
    with contextlib.ExitStack() as stack:
        prop = DTensor._op_dispatcher.sharding_propagator
        for name in ("propagate_op_sharding",
                     "propagate_op_sharding_non_cached"):
            stack.enter_context(_wrapped(prop, name, _modes_off))
        stack.enter_context(_wrapped(placement_types._StridedShard,
                                     "local_shard_size_and_offset",
                                     _modes_off))
        holders = [fc] + [
            m for k, m in list(sys.modules.items())
            if k.startswith("torch.distributed.tensor.") and m is not None
            and tracing is not None
            and getattr(m, "_are_we_tracing", None) is tracing]
        for mod in holders:
            stack.enter_context(_wrapped(mod, "_are_we_tracing",
                                         _fake_mode_unset))
        _QUIET.append(True)
        try:
            yield
        finally:
            _QUIET.pop()


def leaves(tree):
    """The tensors of a tree of dicts, lists, tuples and dataclasses (a
    quantized weight's ``data`` and ``scale``), in order; a ``DTensor``
    stands for its local shard."""
    if isinstance(tree, torch.Tensor):
        yield local(tree)
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from leaves(v)
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            yield from leaves(getattr(tree, f.name))


def distinct_bases(tree) -> list:
    """The distinct tensors of ``tree``, a view standing for its base."""
    seen, out = set(), []
    for t in leaves(tree):
        base = t._base if t._base is not None else t
        if id(base) not in seen:
            seen.add(id(base))
            out.append(base)
    return out


def unique_bytes(tree) -> int:
    """Bytes of the distinct tensors of ``tree``."""
    return sum(t.numel() * t.element_size() for t in distinct_bases(tree))


def analyze_step(fn, *args, **kwargs):
    """Run ``fn(*args, **kwargs)`` under an :class:`OpCounter`; returns
    ``(result, StepStats)``.  ``argument_bytes``: the distinct tensors of
    the arguments; ``output_bytes``: those of the result."""
    counter = OpCounter()
    with counter:
        result = fn(*args, **kwargs)
    return result, counter.stats(
        argument_bytes=unique_bytes((args, kwargs)),
        output_bytes=unique_bytes(result))
