"""Program analyzer: dot FLOPs, collective bytes and memory per device,
counted from the torch program.

The port's counterpart of ``repro/launch/hlo.py``, which parses XLA's
compiled per-partition HLO. Nothing is compiled here: :func:`analyze`
runs the step eagerly on DTensors whose local shards are meta tensors
(no storage) over a ``fake`` process group (collectives are shapes
only), under :class:`Counter`, a dispatch mode that sees every op twice:
once on DTensors, which it hands back to DTensor (``NotImplemented``),
and once on the local shards DTensor then computes with. It counts the
second kind, so every number is per device (per partition), what the
roofline terms need:

  * ``dot_flops``: the matmul family (mm, bmm, addmm, baddbmm,
    convolutions, attention) by ``torch.utils.flop_counter``'s formulas
    (2 x |out| x contraction) on the local shapes;
  * ``collective_bytes`` / ``collective_count`` by kind: each
    ``_c10d_functional`` collective DTensor issues, at its operand's
    local bytes (the reference's definition), and the same bytes by the
    mesh axis its group spans (``collective_bytes_by_axis``);
  * memory: the local bytes of the arguments, of the outputs, of the
    outputs that are arguments updated in place (the reference's
    "alias"), and the peak of the bytes held by storages the program
    made (freed when their last reference dies: a weak reference per
    storage, as ``torch.distributed._tools.mem_tracker`` keeps them).

DTensor's sharding propagation runs ops on fake tensors of the global
shapes; those are not the program and are skipped.

The reference's loop multiplier becomes :attr:`Counter.weight`: a
caller that runs one of ``n`` identical microbatches sets it to ``n``
for that microbatch and back to 1 for the rest (``launch/inputs.py``);
``tests/test_torch_dist.py`` holds the scaled count to the full
loop's. ``collective_bytes_f32`` and ``cpu_upcast_bytes`` are kept for
the record's keys and are 0: XLA on the CPU computes bf16 dots in f32
and all-reduces f32 partials, torch does neither, so nothing is upcast.
"""
from __future__ import annotations

import dataclasses
import weakref

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter",
               "all-to-all", "collective-permute")
_KIND = {"all_gather_into_tensor": "all-gather",
         "all_gather_into_tensor_coalesced": "all-gather",
         "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
         "reduce_scatter_tensor": "reduce-scatter",
         "reduce_scatter_tensor_coalesced": "reduce-scatter",
         "all_to_all_single": "all-to-all"}


@dataclasses.dataclass
class HloAnalysis:
    dot_flops: float                     # per device, loops multiplied
    collective_bytes: dict[str, float]   # per collective kind
    collective_count: dict[str, int]
    loop_trips: list[int]                # the weights counts were scaled by
    collective_bytes_f32: float = 0.0    # nothing is upcast: see above
    cpu_upcast_bytes: float = 0.0
    collective_bytes_by_axis: dict[str, float] = dataclasses.field(
        default_factory=dict)
    memory: dict[str, int] = dataclasses.field(default_factory=dict)

    @property
    def total_collective_bytes(self) -> float:
        return sum(self.collective_bytes.values())


def _local(t: torch.Tensor) -> torch.Tensor:
    return t.to_local() if isinstance(t, DTensor) else t


def _tensors(tree) -> list[torch.Tensor]:
    return [_local(t) for t in tree_flatten(tree)[0]
            if isinstance(t, torch.Tensor)]


def _storage_bytes(tensors) -> tuple[int, set[int]]:
    """Summed bytes of the distinct storages of ``tensors``, and their
    keys."""
    seen: dict[int, int] = {}
    for t in tensors:
        st = t.untyped_storage()
        seen.setdefault(st._cdata, st.nbytes())
    return sum(seen.values()), set(seen)


class Counter(TorchDispatchMode):
    """Counts dot FLOPs, collectives and live bytes on local shards (see
    the module's docstring). ``axis_of`` maps a process group's name to
    the mesh axis it spans."""

    def __init__(self, axis_of: dict[str, str] | None = None):
        super().__init__()
        self.axis_of = axis_of or {}
        self.weight = 1
        self.weights: list[int] = []
        self.dot_flops = 0.0
        self.cbytes = {k: 0.0 for k in COLLECTIVES}
        self.ccount = {k: 0 for k in COLLECTIVES}
        self.by_axis: dict[str, float] = {}
        self.live = 0
        self.peak = 0
        self._held: dict[int, tuple] = {}

    def set_weight(self, w: int) -> None:
        self.weight = w
        if w != 1:
            self.weights.append(w)

    def _release(self, key: int, _ref) -> None:
        held = self._held.pop(key, None)
        if held is not None:
            self.live -= held[1]

    def _track(self, inputs, out) -> None:
        """Hold the storages ``out`` brings that no input had (a view or
        an in-place op brings none)."""
        old = {t.untyped_storage()._cdata for t in inputs
               if isinstance(t, torch.Tensor)}
        for t in tree_flatten(out)[0]:
            if not isinstance(t, torch.Tensor):
                continue
            st = t.untyped_storage()
            key = st._cdata
            if key in self._held or key in old:
                continue
            n = st.nbytes()
            self._held[key] = (weakref.ref(st, lambda r, k=key:
                                           self._release(k, r)), n)
            self.live += n
            self.peak = max(self.peak, self.live)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        flat = tree_flatten((args, kwargs, out))[0]
        if any(isinstance(t, FakeTensor) for t in flat):
            return out              # DTensor's sharding propagation
        packet = func._overloadpacket
        if packet in flop_registry:
            self.dot_flops += self.weight * flop_registry[packet](
                *args, **kwargs, out_val=out)
        if func.namespace.startswith("_c10d_functional"):
            kind = _KIND.get(packet.__name__)
            if kind is not None:
                nbytes = args[0].numel() * args[0].element_size()
                self.cbytes[kind] += self.weight * nbytes
                self.ccount[kind] += self.weight
                axis = self.axis_of.get(args[-1], str(args[-1]))
                self.by_axis[axis] = self.by_axis.get(axis, 0.0) + \
                    self.weight * nbytes
        self._track(tree_flatten((args, kwargs))[0], out)
        return out


def axes_of_mesh(mesh) -> dict[str, str]:
    """{process-group name: mesh axis name} for each mesh dimension."""
    return {mesh.get_group(i).group_name: name
            for i, name in enumerate(mesh.mesh_dim_names)}


def analyze(fn, *args, mesh=None, counter: Counter | None = None):
    """Run ``fn(*args)`` under a :class:`Counter` and return
    (:class:`HloAnalysis`, ``fn``'s output). ``fn`` may set the
    counter's weight itself when it is passed in as ``counter``."""
    c = counter or Counter()
    if mesh is not None:
        c.axis_of = axes_of_mesh(mesh)
    arg_tensors = _tensors(args)
    arg_bytes, arg_keys = _storage_bytes(arg_tensors)
    with c:
        out = fn(*args)
    outs = _tensors(out)
    out_bytes, out_keys = _storage_bytes(outs)
    alias_bytes, _ = _storage_bytes(
        t for t in outs if t.untyped_storage()._cdata in arg_keys)
    new_out = out_bytes - alias_bytes
    memory = {"argument_size_in_bytes": arg_bytes,
              "output_size_in_bytes": out_bytes,
              "alias_size_in_bytes": alias_bytes,
              "temp_size_in_bytes": max(0, c.peak - new_out)}
    return HloAnalysis(dot_flops=c.dot_flops, collective_bytes=c.cbytes,
                       collective_count=c.ccount,
                       loop_trips=sorted(c.weights),
                       collective_bytes_by_axis=c.by_axis,
                       memory=memory), out
