"""Routing of the port's kernels between kernel and plain version: the
quantized matmuls, the int8-KV decode attention and flash attention.

``impl``:

* ``"auto"``: the CUDA kernel for CUDA tensors, the plain version for CPU
  tensors;
* ``"kernel"``: the CUDA kernel; raises for CPU tensors;
* ``"ref"``: the plain version on the tensors' device.

The kernels have no backward: they write their outputs through ctypes,
outside autograd (the reference's Pallas kernels have no ``custom_vjp``
either, and it trains through its plain XLA route).  So one rule comes
before the device: where autograd would record the operation (grad is
enabled and an operand that carries a gradient requires it,
:func:`needs_grad`), ``"auto"`` takes the plain version, which autograd
differentiates, and ``"kernel"`` raises.  Under ``torch.no_grad()`` the
card routes as above.

A fake tensor (``torch._subclasses.FakeTensor``: a shape with no
storage, as the dry run of ``launch/dryrun.py`` builds a step) has nothing
to launch on: every ``impl`` sends it to the plain version, which gives
the output's shape.

While an op counter of ``core/op_analysis.py`` is active, each entry runs
inside a kernel scope with the kernel's cost (``cost()`` beside each
kernel), whichever route runs, so a step counts the same work on the
card, on the CPU and under fake tensors.  Under grad there is no kernel
and no scope: the plain version is counted op by op.

Operands that are ``DTensor``s (a step placed on a ``DeviceMesh``, the
dry run's pod cells) run on their local shards through
``torch.distributed.tensor.experimental.local_map``, the counterpart of
the reference's ``shard_map``: :func:`on_local_shards` reads each
operand's placements, picks per mesh dim the one role of a dimension the
kernel can split (the batch or token rows, the heads, the output
columns, or the contraction, which leaves a ``Partial`` sum), moves the
operands there (the collectives counted) and calls the same entry on the
local tensors, so the kernel launches (or its plain version runs) and
its cost is counted at one card's shapes.  The x scale of a quantized
matmul is per tensor: the caller takes it on the ``DTensor``, a global
amax and an all-reduce, before the local product.

A failed build or launch raises; nothing falls back.  The reference's
padding to block multiples (and its assertion of divisible lengths for
flash attention) has no counterpart: the kernels mask ragged edges
themselves.
"""

from __future__ import annotations

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.utils._python_dispatch import _disable_current_modes

from repro_torch.core import op_analysis
from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import w4a8_matmul as _w4a8
from repro_torch.kernels import w8a8_decode as _dec
from repro_torch.kernels import w8a8_matmul as _w8a8

IMPLS = ("auto", "kernel", "ref")


def needs_grad(*tensors) -> bool:
    """Whether autograd would record an operation on ``tensors``: grad is
    enabled and one of them requires it."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def on_card(x: torch.Tensor) -> bool:
    """Whether ``"auto"`` finds ``x`` on a device that runs the kernels."""
    return x.device.type != "cpu"


def is_fake(x: torch.Tensor) -> bool:
    """Whether ``x`` is a fake tensor (a shape without storage)."""
    return isinstance(x, FakeTensor)


def use_kernel(x_q: torch.Tensor, impl: str, *, grad=()) -> bool:
    """Whether ``impl`` sends an operation on ``x_q``'s device to its
    kernel.  ``grad``: the operands a gradient would flow through; when
    :func:`needs_grad` holds for them the plain version runs (``"auto"``)
    or the call raises (``"kernel"``), since no kernel has a backward.  A
    fake ``x_q`` takes the plain version."""
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    if needs_grad(*grad):
        if impl == "kernel":
            raise RuntimeError(
                "the CUDA kernels have no backward: an operand requires "
                "grad under torch.is_grad_enabled(); use impl='auto' (the "
                "plain version under grad) or torch.no_grad()")
        return False
    if is_fake(x_q):
        return False
    return impl == "kernel" or (impl == "auto" and on_card(x_q))


def counted(name: str, cost, run, *, grad=()):
    """``run()`` inside the active op counter's kernel scope of ``name``
    with the cost ``cost()`` gives, its output followed as a result;
    ``run()`` alone without a counter or under grad (:func:`needs_grad`
    of ``grad``: no kernel runs, the plain version is counted op by
    op)."""
    counter = op_analysis.active()
    if counter is None or needs_grad(*grad):
        return run()
    with counter.kernel_scope(name, *cost()):
        out = run()
    counter.track(out)
    return out


def sharded(*tensors) -> bool:
    """Whether any of ``tensors`` is a ``DTensor``."""
    cls = op_analysis._dtensor_class()
    return cls is not None and any(isinstance(t, cls) for t in tensors)


def on_local_shards(fn, operands, roles, out_roles, *, split=(),
                    sums=()):
    """``fn(*locals)`` on one card's shards of ``operands``.

    ``roles[i]``: a name for each dim of ``operands[i]`` (None for a
    non-tensor operand, passed as it is); ``out_roles``: the names of the
    output's dims (a tuple of them for each output where ``fn`` returns
    a tuple).  For each mesh dim, the first operand sharded on it
    (exactly, by ``Shard``) names a role; the role is kept if it is in
    ``split`` (or ``sums``) and every operand dim of that role divides
    over the mesh dims it takes; otherwise the mesh dim is replicated.
    Every operand is moved to those placements (``local_map`` with
    ``redistribute_inputs``: the collectives the move needs, counted) and
    the output is placed ``Shard`` on its dim of the role, ``Partial``
    for a role in ``sums`` (a contraction split over ranks), else
    ``Replicate``.  Under autograd an operand whole on a mesh dim that
    another splits gets a ``Partial`` gradient there.  Plain tensors
    among ``operands`` are taken as replicated."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = next(t.device_mesh for t in operands if isinstance(t, DTensor))
    ops_ = [DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                               run_check=False)
            if isinstance(t, torch.Tensor) and not isinstance(t, DTensor)
            else t for t in operands]
    factor: dict = {}                     # role -> ranks it is split over
    chosen = []
    for i in range(mesh.ndim):
        n = mesh.size(i)
        pick = None
        for t, r in zip(ops_, roles):
            if not isinstance(t, DTensor):
                continue
            p = t.placements[i]
            if type(p) is Shard:
                pick = r[p.dim]
                break
        if pick is not None and n > 1:
            ok = pick in split or pick in sums
            for t, r in zip(ops_, roles):
                if ok and isinstance(t, DTensor):
                    for d, name in enumerate(r):
                        if name == pick and t.shape[d] % (
                                factor.get(pick, 1) * n):
                            ok = False
            pick = pick if ok else None
        elif n == 1:
            pick = None
        if pick is not None:
            factor[pick] = factor.get(pick, 1) * n
        chosen.append(pick)

    def placements(r):
        return tuple(Shard(r.index(c)) if c is not None and c in r
                     else Replicate() for c in chosen)
    in_pl = tuple(None if r is None else placements(r) for r in roles)
    # an operand whole on a mesh dim that the work is split on gets each
    # rank's part of its gradient: a Partial sum
    grad_pl = tuple(None if r is None else tuple(
        Shard(r.index(c)) if c is not None and c in r
        else Partial() if c is not None else Replicate() for c in chosen)
        for r in roles)
    def out_placements(o):
        return [Partial() if c in sums else Shard(o.index(c)) if c in o
                else Replicate() for c in chosen]
    # one output: a list (local_map reads a tuple as one placement list
    # an output); several (``out_roles`` a tuple of role tuples): a tuple
    if out_roles and isinstance(out_roles[0], tuple):
        out_pl = tuple(out_placements(o) for o in out_roles)
    else:
        out_pl = out_placements(out_roles)
    return local_map(fn, out_placements=out_pl, in_placements=in_pl,
                     in_grad_placements=grad_pl,
                     redistribute_inputs=True)(*ops_)


def live_keys(pos, b: int, S: int) -> list[int]:
    """The keys each of ``b`` rows reads at ``pos`` (an int, a 0-d or a
    ``(b,)`` tensor): ``min(pos, S - 1) + 1``.  A tensor is read on the
    host with the counter paused; a fake one has no values, so every row
    counts all ``S`` keys."""
    if isinstance(pos, torch.Tensor):
        if is_fake(pos):
            return [S] * b
        with _disable_current_modes():
            vals = pos.reshape(-1).tolist()
        vals = vals * b if len(vals) == 1 else vals
    else:
        vals = [int(pos)] * b
    return [min(max(p, 0), S - 1) + 1 for p in vals]


def w8a8_matmul(x_q, w_q, x_scale, w_scale, *, out_dtype=torch.float32,
                impl: str = "auto") -> torch.Tensor:
    """x_q (m, k) int8 x w_q (k, n) int8, dequantized by the scalar
    ``x_scale`` and per-column ``w_scale``."""
    if sharded(x_q, w_q, x_scale, w_scale):
        return _matmul_on_shards(w8a8_matmul, x_q, w_q, x_scale, w_scale,
                                 out_dtype, impl)
    fn = _w8a8.w8a8_matmul if use_kernel(x_q, impl, grad=(x_scale, w_scale)) \
        else _w8a8.w8a8_matmul_ref
    return counted("w8a8_matmul", lambda: _w8a8.cost(
        x_q.shape[0], x_q.shape[1], w_q.shape[1], out_dtype),
        lambda: fn(x_q, w_q, x_scale, w_scale, out_dtype=out_dtype),
        grad=(x_scale, w_scale))


def _matmul_on_shards(entry, x_q, w, x_scale, w_scale, out_dtype, impl):
    """A quantized matmul on local shards: rows, output columns or the
    contraction (a ``Partial`` output) split over ranks; the scalar x
    scale whole on every rank."""
    return on_local_shards(
        lambda x, w_, xs, ws: entry(x, w_, xs, ws, out_dtype=out_dtype,
                                    impl=impl),
        (x_q, w, x_scale, w_scale),
        (("m", "k"), ("k", "n"), (), ("n",)), ("m", "n"),
        split=("m", "n"), sums=("k",))


def w4a8_matmul(x_q, w_packed, x_scale, w_scale, *,
                out_dtype=torch.float32, impl: str = "auto") -> torch.Tensor:
    """x_q (m, k) int8 x w_packed (k/2, n) packed pow2 codes, dequantized
    by the scalar ``x_scale`` and per-column ``w_scale``."""
    if sharded(x_q, w_packed, x_scale, w_scale):
        return _matmul_on_shards(w4a8_matmul, x_q, w_packed, x_scale,
                                 w_scale, out_dtype, impl)
    fn = _w4a8.w4a8_matmul if use_kernel(x_q, impl, grad=(x_scale, w_scale)) \
        else _w4a8.w4a8_matmul_ref
    return counted("w4a8_matmul", lambda: _w4a8.cost(
        x_q.shape[0], x_q.shape[1], w_packed.shape[1], out_dtype),
        lambda: fn(x_q, w_packed, x_scale, w_scale, out_dtype=out_dtype),
        grad=(x_scale, w_scale))


def flash_attention(q, k, v, *, causal: bool = True, window=None,
                    scale=None, impl: str = "auto") -> torch.Tensor:
    """Attention forward over q, k, v ``(b, h, s, d)`` with the kv heads
    broadcast (see ``flash_attention.flash_attention_ref``)."""
    fn = _flash.flash_attention if use_kernel(q, impl, grad=(q, k, v)) \
        else _flash.flash_attention_ref
    b, h, sq, d = q.shape
    return counted("flash_attention", lambda: _flash.cost(
        b, h, sq, k.shape[2], d, causal=causal, window=window,
        dtype=q.dtype), lambda: fn(q, k, v, causal=causal, window=window,
                                   scale=scale), grad=(q, k, v))


def w8a8_decode_attention(q, k_q, v_q, k_scale, v_scale, pos, *,
                          bs: int = 512, impl: str = "auto") -> torch.Tensor:
    """int8-KV grouped decode attention, q quantized in float32 (the TPU
    entry point; see ``w8a8_decode.w8a8_decode_attention_ref``)."""
    fn = _dec.w8a8_decode_attention \
        if use_kernel(q, impl, grad=(q, k_scale, v_scale)) \
        else _dec.w8a8_decode_attention_ref
    b, kvh, rep, hd = q.shape
    return counted("w8a8_decode_attention", lambda: _dec.cost(
        b, kvh, rep, hd, live_keys(pos, b, k_q.shape[1]),
        q_row_bytes=hd * q.element_size(), out_dtype=q.dtype),
        lambda: fn(q, k_q, v_q, k_scale, v_scale, pos, bs=bs),
        grad=(q, k_scale, v_scale))


#: the decode body's operands by dim: batch, kv head, q row of a group,
#: head dim, key position; a sequence-split cache is gathered whole
_DECODE_ROLES = (("b", "g", "r", "d"), ("b", "g", "r"), ("b", "s", "g", "d"),
                 ("b", "s", "g", "d"), ("b", "s", "g"), ("b", "s", "g"))


def w8a8_decode_attention_body(q_q, factor, k_q, v_q, k_scale, v_scale, pos,
                               *, bs: int, out_dtype=torch.float32,
                               impl: str = "auto") -> torch.Tensor:
    """The body of :func:`w8a8_decode_attention` on q codes and per-row
    logit factors that the caller computed (the model's bf16 form);
    ``pos`` an int or a ``(b,)`` int32 tensor."""
    fn = _dec.w8a8_decode_attention_body \
        if use_kernel(q_q, impl, grad=(factor, k_scale, v_scale)) \
        else _dec.w8a8_decode_attention_body_ref
    if sharded(q_q, factor, k_q, v_q, k_scale, v_scale):
        return on_local_shards(
            lambda *t: w8a8_decode_attention_body(
                *t, pos, bs=bs, out_dtype=out_dtype,
                impl=impl),
            (q_q, factor, k_q, v_q, k_scale, v_scale), _DECODE_ROLES,
            ("b", "g", "r", "d"), split=("b", "g"))
    b, kvh, rep, hd = q_q.shape

    def run():
        return fn(q_q, factor, k_q, v_q, k_scale, v_scale,
                  _dec.positions(pos, b, q_q.device), bs=bs,
                  out_dtype=out_dtype)
    return counted("w8a8_decode_attention", lambda: _dec.cost(
        b, kvh, rep, hd, live_keys(pos, b, k_q.shape[1]),
        out_dtype=out_dtype), run, grad=(factor, k_scale, v_scale))
