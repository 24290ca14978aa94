"""Logical-axis sharding rules engine, as DTensor placements.

Port of ``repro/dist/sharding.py``. Arrays are described by *logical*
axis names ("batch", "d_ff", ...); a rules dict maps logical names to
mesh axes. :func:`spec_entries` resolves names to the reference's
``PartitionSpec`` entries (a tuple: per tensor dimension a mesh axis, a
tuple of axes or None, trailing Nones dropped) with its three
safeguards:

  * every mesh axis is used by at most one tensor dimension (first dim
    in order wins; a later dim whose rule names a taken axis shards on
    the rule's remaining untaken axes, or replicates if none are left),
  * a dimension only shards if its size divides the product of its mesh
    axes (non-divisible dims replicate, e.g. a global batch of 1, or 15
    heads on a 16-way model axis),
  * rule entries naming mesh axes absent from the mesh are dropped (so
    one rules dict serves single-pod and multi-pod meshes).

:func:`spec_for` says the same for a :class:`DeviceMesh`: one placement
per mesh dimension, ``Shard(d)`` where the dimension shards tensor dim
``d`` and ``Replicate()`` elsewhere.

A tensor dim sharded over two mesh axes keeps the reference's major
axis: DTensor cuts in mesh-dimension order unless told otherwise, so
FSDP's ``("model", "data")`` on the ``("data", "model")`` mesh becomes
``(_StridedShard(d, split_factor=16), Shard(d))`` (:func:`placements_of`):
every device holds the rows the reference gives it, and gathering the
data axis for compute is one all-gather of the local shard (its
gradient one reduce-scatter), as in FSDP2's 2-D layout.

``mesh`` may be a :class:`~torch.distributed.device_mesh.DeviceMesh` or
any object with ``mesh_dim_names`` and ``shape`` (tests use a stand-in).

:func:`constrain` is the model-internal activation hook: it returns
``x`` itself unless an :func:`activation_sharding` context is active
(models stay mesh-agnostic; the launch layer binds the context per
cell). Inside one it redistributes a DTensor to the placements its
logical names resolve to.
"""
from __future__ import annotations

import contextlib
import math
import threading
from typing import Any, Iterable, Mapping, Sequence

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.tensor._utils import \
    compute_local_shape_and_global_offset
from torch.distributed.tensor.experimental import implicit_replication
from torch.distributed.tensor.placement_types import _StridedShard

DEFAULT_RULES: dict[str, Any] = {
    "batch": ("pod", "data"),
    "kv_seq": "data",
    "heads": "model",
    "kv_heads": "model",
    "heads_x_dim": "model",
    "d_ff": "model",
    "d_inner": "model",
    "vocab": "model",
    "experts": "model",
    "kv_stored": "model",
}


def _as_axes(value: Any) -> tuple[str, ...]:
    if value is None:
        return ()
    if isinstance(value, str):
        return (value,)
    return tuple(value)


def _merged_rules(rules: Mapping[str, Any] | None) -> dict[str, tuple]:
    out = {k: _as_axes(v) for k, v in DEFAULT_RULES.items()}
    if rules:
        out.update({k: _as_axes(v) for k, v in rules.items()})
    return out


def mesh_sizes(mesh) -> dict[str, int]:
    """{axis name: size} of a DeviceMesh (or a stand-in)."""
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


def spec_entries(shape: Sequence[int], names: Sequence[str | None],
                 mesh, rules: Mapping[str, Any] | None = None) -> tuple:
    """The reference's ``PartitionSpec`` entries for an array of
    ``shape`` with logical ``names``."""
    merged = _merged_rules(rules)
    sizes = mesh_sizes(mesh)
    taken: set[str] = set()
    entries: list[Any] = []
    for dim, name in zip(shape, names):
        axes = [a for a in merged.get(name, ())
                if a in sizes and a not in taken] if name else []
        total = math.prod(sizes[a] for a in axes) if axes else 1
        if axes and dim % total == 0:
            taken.update(axes)
            entries.append(tuple(axes) if len(axes) > 1 else axes[0])
        else:
            entries.append(None)
    while entries and entries[-1] is None:
        entries.pop()
    return tuple(entries)


def placements_of(entries: Sequence[Any], mesh) -> tuple:
    """Spec entries -> one placement per mesh dimension.

    An entry of several axes lists them major first. In mesh order that
    is ``Shard(d)`` on each; two axes in the other order (FSDP's
    ``("model", "data")`` on the ``("data", "model")`` mesh) make the
    earlier mesh dimension a ``_StridedShard(d, split_factor=<the
    other axis' size>)``, DTensor's spelling of "minor" (FSDP2's 2-D
    layout), so that each device holds the reference's rows. An axis of
    size 1 places nothing (``Replicate()``)."""
    names = list(mesh.mesh_dim_names)
    sizes = mesh_sizes(mesh)
    out: list = [Replicate()] * len(names)
    for d, e in enumerate(entries):
        # A shard over one device is the whole tensor: Replicate() says
        # so to DTensor, whose view rules refuse some reshapes of a
        # dimension "sharded" over a mesh dimension of size 1.
        axes = tuple(a for a in _as_axes(e) if sizes[a] > 1)
        order = sorted(axes, key=names.index)
        for a in axes:
            out[names.index(a)] = Shard(d)
        if list(axes) == order:
            continue
        if len(axes) != 2:
            raise NotImplementedError(
                f"entry {axes}: only two axes may be out of mesh order")
        out[names.index(order[0])] = _StridedShard(
            d, split_factor=sizes[order[1]])
    return tuple(out)


def spec_for(shape: Sequence[int], names: Sequence[str | None],
             mesh, rules: Mapping[str, Any] | None = None) -> tuple:
    """Placements (one per mesh dimension) for a tensor of ``shape``
    with logical ``names``."""
    return placements_of(spec_entries(shape, names, mesh, rules), mesh)


def _is_names(x) -> bool:
    return x is None or (isinstance(x, tuple) and
                         all(a is None or isinstance(a, str) for a in x))


def tree_shardings(axes_tree, mesh, rules: Mapping[str, Any] | None,
                   shapes_tree):
    """Placements for every leaf of ``shapes_tree`` (nested dicts and
    lists of tensors, or of anything with a ``shape``).

    ``axes_tree`` mirrors ``shapes_tree`` with tuples of logical names
    (or None for fully replicated leaves) in place of tensors.
    """
    if isinstance(shapes_tree, Mapping):
        if not isinstance(axes_tree, Mapping) or \
                set(axes_tree) != set(shapes_tree):
            raise ValueError(
                f"axes tree keys {sorted(axes_tree)} differ from the "
                f"shapes tree's {sorted(shapes_tree)}")
        return {k: tree_shardings(axes_tree[k], mesh, rules, v)
                for k, v in shapes_tree.items()}
    if isinstance(shapes_tree, (list, tuple)):
        if len(axes_tree) != len(shapes_tree):
            raise ValueError(
                f"axes tree has {len(axes_tree)} leaves, shapes tree "
                f"{len(shapes_tree)}")
        return type(shapes_tree)(
            tree_shardings(a, mesh, rules, s)
            for a, s in zip(axes_tree, shapes_tree))
    if not _is_names(axes_tree):
        raise ValueError(f"not a tuple of logical names: {axes_tree!r}")
    shape = tuple(shapes_tree.shape)
    names = axes_tree if axes_tree is not None else (None,) * len(shape)
    return spec_for(shape, names, mesh, rules)


def batch_entries(mesh, extra_dims: int = 1,
                  rules: Mapping[str, Any] | None = None,
                  batch_size: int | None = None) -> tuple:
    """The reference's ``batch_spec`` entries: dim 0 on the batch axes,
    the ``extra_dims`` trailing dims replicated.

    When ``batch_size`` is known, a non-divisible batch replicates
    (the spec_for safeguard); when unknown, the caller owns ensuring
    the batch divides the mesh's batch axes.
    """
    merged = _merged_rules(rules)
    sizes = mesh_sizes(mesh)
    axes = [a for a in merged.get("batch", ()) if a in sizes]
    if batch_size is not None and axes and \
            batch_size % math.prod(sizes[a] for a in axes) != 0:
        axes = []
    if not axes:
        return ()
    entry = tuple(axes) if len(axes) > 1 else axes[0]
    return (entry, *(None,) * extra_dims)


def batch_spec(mesh, extra_dims: int = 1,
               rules: Mapping[str, Any] | None = None,
               batch_size: int | None = None) -> tuple:
    """Placements for a (batch, ...) tensor (see :func:`batch_entries`)."""
    return placements_of(
        batch_entries(mesh, extra_dims, rules, batch_size), mesh)


# -- activation-sharding context --------------------------------------------

_ctx = threading.local()


@contextlib.contextmanager
def activation_sharding(mesh, rules: Mapping[str, Any] | None):
    """Bind (mesh, rules) so model-internal :func:`constrain` calls
    resolve; contexts nest (innermost wins)."""
    stack = getattr(_ctx, "stack", None)
    if stack is None:
        stack = _ctx.stack = []
    stack.append((mesh, rules))
    try:
        yield
    finally:
        stack.pop()


def bound_to(fn, mesh, rules: Mapping[str, Any] | None):
    """``fn`` run under :func:`activation_sharding` of (mesh, rules) and
    ``implicit_replication``: the model's constraints bind to the cell's
    rules, and the tensors the modules make themselves (masks, position
    tables) count as replicated."""
    def wrapped(*args):
        with activation_sharding(mesh, rules), implicit_replication():
            return fn(*args)

    return wrapped


def current():
    """The innermost (mesh, rules) binding, or None."""
    stack = getattr(_ctx, "stack", None)
    return stack[-1] if stack else None


def constrain(x, names: Iterable[str | None]):
    """Apply a logical sharding constraint to activation ``x``.

    Returns ``x`` itself outside an :func:`activation_sharding`
    context, so models run unmeshed in unit tests. Inside one, a
    DTensor is redistributed to the placements of its names (a pending
    ``Partial`` sum is reduced on the way, as XLA's constraint does), and
    its gradient is redistributed to the same placements. A plain tensor
    is returned as it is: the modules' own tensors (masks, position
    tables) count as replicated (``implicit_replication``), and code
    that runs on one device's local shards (a :func:`run_local` body,
    its checkpointed recomputation too) constrains nothing.
    """
    bound = current()
    if bound is None or not isinstance(x, DTensor):
        return x
    mesh, rules = bound
    placements = spec_for(tuple(x.shape), tuple(names), mesh, rules)
    if tuple(x.placements) == placements and not x.requires_grad:
        return x
    return _Constrain.apply(x, mesh, placements)


class _Constrain(torch.autograd.Function):
    """XLA's sharding constraint: the value takes ``placements``, and so
    does its gradient (the constraint's transpose is the same
    constraint). DTensor's own ``redistribute`` sends a gradient back to
    the input's placements instead, which leaves a residual stream's
    gradient a Partial sum that every later weight gradient pays for."""

    @staticmethod
    def forward(ctx, x, mesh, placements):
        ctx.mesh, ctx.placements = mesh, placements
        if tuple(x.placements) == placements:
            return x.view_as(x)
        return x.redistribute(mesh, placements)

    @staticmethod
    def backward(ctx, g):
        if isinstance(g, DTensor) and tuple(g.placements) != ctx.placements:
            g = g.redistribute(ctx.mesh, ctx.placements)
        return g, None, None


def zeros(shape: Sequence[int], names: Sequence[str | None], *,
          dtype: torch.dtype, device) -> torch.Tensor:
    """``torch.zeros(shape)``; inside a context a DTensor placed by
    ``names`` that holds only its local shard (no global buffer is ever
    made)."""
    bound = current()
    if bound is None:
        return torch.zeros(tuple(shape), dtype=dtype, device=device)
    mesh, rules = bound
    shape = torch.Size(shape)
    placements = spec_for(shape, names, mesh, rules)
    local, _ = compute_local_shape_and_global_offset(shape, mesh,
                                                     placements)
    return DTensor.from_local(
        torch.zeros(local, dtype=dtype, device=device), mesh, placements,
        run_check=False, shape=shape,
        stride=torch.empty(shape, device="meta").stride())


def unflatten(x, dim: int, sizes: Sequence[int]):
    """``x.unflatten(dim, sizes)``. On a mesh DTensor refuses to split a
    dimension whose shard count does not divide the first factor (40
    RWKV heads of 64 over 16 ranks): that dimension is gathered first,
    a collective the dry run counts."""
    if isinstance(x, DTensor):
        ways = math.prod(x.device_mesh.size(i)
                         for i, p in enumerate(x.placements)
                         if getattr(p, "dim", None) == dim)
        if sizes[0] % ways:
            x = gather_dim(x, dim)
    return x.unflatten(dim, sizes)


def _local_contiguous(t):
    """A DTensor's copy whose local shard is contiguous (``t`` itself if
    it is). DTensor's own ``contiguous`` looks at the global strides."""
    if not isinstance(t, DTensor) or t.to_local().is_contiguous():
        return t
    return t.clone(memory_format=torch.contiguous_format)


def contiguous_grad(x):
    """``x``, whose gradient's local shard is made contiguous on the way
    back (a DTensor only). DTensor decides whether a reshape is a view
    from the global tensor's strides, not its shard's: a gradient whose
    shard is laid out transposed (attention's backward) would reach a
    view, in an einsum's backward, that its shard cannot take."""
    if not isinstance(x, DTensor):
        return x
    return _ContiguousGrad.apply(x)


class _ContiguousGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _local_contiguous(g)


def flatten(x, dim: int, sizes: Sequence[int]):
    """``x.flatten(dim, dim + 1)`` of two dimensions of ``sizes``; on a
    mesh its gradient is split back by :func:`unflatten` (so a
    gradient sharded unevenly over the first factor is gathered
    first), where DTensor's own view backward refuses it."""
    if not isinstance(x, DTensor):
        return x.flatten(dim, dim + 1)
    return _Flatten.apply(x, dim, tuple(sizes))


class _Flatten(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, sizes):
        ctx.dim, ctx.sizes = dim, sizes
        return x.flatten(dim, dim + 1)

    @staticmethod
    def backward(ctx, g):
        return unflatten(g, ctx.dim, ctx.sizes), None, None


def run_local(fn, dts: Sequence, rest: Sequence, out_like):
    """``fn(*locals, *rest)`` on the local shards of the DTensors
    ``dts``, its output a DTensor placed as ``out_like`` (the same
    global shape and placements): torch's ``local_map``, whose backward
    on torch 2.11 wraps these gradients in a second DTensor. Here each
    gradient crosses the boundary as one local tensor, redistributed
    to the placements it left with."""
    locals_ = [_ToLocal.apply(x) for x in dts]
    out = fn(*locals_, *rest)
    return _FromLocal.apply(out, out_like.device_mesh,
                            tuple(out_like.placements), out_like.shape,
                            out_like.stride())


def _plain(g, mesh, placements):
    """A gradient as the local shard of ``placements``."""
    while isinstance(g, DTensor):
        if tuple(g.placements) != tuple(placements):
            g = g.redistribute(mesh, placements)
        g = g.to_local()
    return g


class _ToLocal(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.mesh, ctx.placements = x.device_mesh, tuple(x.placements)
        ctx.shape, ctx.stride = x.shape, x.stride()
        return x.to_local().view_as(x.to_local())

    @staticmethod
    def backward(ctx, g):
        return DTensor.from_local(_plain(g, ctx.mesh, ctx.placements),
                                  ctx.mesh, ctx.placements, run_check=False,
                                  shape=ctx.shape, stride=ctx.stride)


class _FromLocal(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, placements, shape, stride):
        ctx.mesh, ctx.placements = mesh, placements
        return DTensor.from_local(t, mesh, placements, run_check=False,
                                  shape=shape, stride=stride)

    @staticmethod
    def backward(ctx, g):
        return _plain(g, ctx.mesh, ctx.placements), None, None, None, None


def unshard_grad(x, dim: int):
    """``x`` itself outside a context. Inside one, an identity whose
    backward gathers the gradient's dimension ``dim`` (its ``Shard(dim)``
    placements become ``Replicate()``) before the op that made ``x``
    sees it: for ops whose backward DTensor cannot run on a sharded
    dimension (``repeat_interleave``'s sum over the copies of a head is
    a view that splits it)."""
    if current() is None or not isinstance(x, DTensor):
        return x
    return _UnshardGrad.apply(x, dim)


def gather_dim(t, dim: int):
    """A DTensor with dimension ``dim`` whole on every device (its
    shards gathered); anything else as it is."""
    if not isinstance(t, DTensor) or all(
            getattr(p, "dim", None) != dim for p in t.placements):
        return t
    return t.redistribute(t.device_mesh, [
        Replicate() if getattr(p, "dim", None) == dim else p
        for p in t.placements])


class _UnshardGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim):
        ctx.dim = dim
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return gather_dim(g, ctx.dim), None
