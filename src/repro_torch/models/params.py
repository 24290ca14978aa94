"""Declarative parameter specs.

Every module declares its parameters as a nested dict of :class:`Spec`
(shape + logical axes + initializer), as the reference does. From one
spec tree the port derives a :class:`Params` module (the tree's
parameters as ``nn.Parameter``s, named by their Spec path) and its
initial values (``init``), drawn on the module's device from one
``torch.Generator``.

Layer stacks keep :func:`stack_specs` for counting; the port's model
holds one :class:`Params` per layer instead of stacked arrays. The
logical axes ride along for the placements of the distribution layer.
"""
from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn


@dataclasses.dataclass(frozen=True)
class Spec:
    shape: tuple[int, ...]
    axes: tuple[str | None, ...]
    init: str = "normal"      # normal | zeros | ones
    scale: float | None = None  # None -> 1/sqrt(fan_in) for normal

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


def _is_spec(x) -> bool:
    return isinstance(x, Spec)


def leaves(specs, prefix: str = "") -> list[tuple[str, Spec]]:
    """(dotted path, Spec) of every leaf, in the tree's insertion order."""
    if _is_spec(specs):
        return [(prefix, specs)]
    out = []
    for k, v in specs.items():
        out += leaves(v, f"{prefix}.{k}" if prefix else k)
    return out


def stack_specs(tree, n: int, axis_name: str | None = "layers"):
    """Prepend a stacking dimension of size ``n`` to every Spec."""
    if _is_spec(tree):
        return Spec((n, *tree.shape), (axis_name, *tree.axes), tree.init,
                    tree.scale)
    return {k: stack_specs(v, n, axis_name) for k, v in tree.items()}


def std(spec: Spec) -> float:
    """The standard deviation ``init`` draws a normal Spec with: the
    override, else 1/sqrt(fan_in) with fan_in = shape[-2] (shape[-1] for
    a vector), as the reference's ``_init_one``."""
    if spec.scale is not None:
        return spec.scale
    fan_in = spec.shape[-2] if len(spec.shape) >= 2 else spec.shape[-1]
    return 1.0 / math.sqrt(max(1, fan_in))


@torch.no_grad()
def init_(p: torch.Tensor, spec: Spec, generator: torch.Generator) -> None:
    """Fill ``p`` in place: zeros, ones, or a float32 normal draw times
    :func:`std`, cast to ``p``'s dtype."""
    if spec.init == "zeros":
        p.zero_()
    elif spec.init == "ones":
        p.fill_(1.0)
    elif p.dtype == torch.float32:
        p.normal_(0.0, std(spec), generator=generator)
    else:
        p.copy_(torch.empty(p.shape, dtype=torch.float32, device=p.device)
                .normal_(0.0, std(spec), generator=generator))


class Params(nn.Module):
    """A spec tree as a module: each Spec an ``nn.Parameter`` of its
    shape, each sub-dict a child ``Params``. Indexing (``p["wq"]``) and
    ``in`` read it as the reference's functions read their dicts, so the
    layer functions take either."""

    def __init__(self, specs: dict, *, device: torch.device,
                 dtype: torch.dtype):
        super().__init__()
        for name, s in specs.items():
            if _is_spec(s):
                self.register_parameter(name, nn.Parameter(
                    torch.empty(s.shape, device=device, dtype=dtype),
                    requires_grad=False))
            else:
                self.add_module(name, Params(s, device=device, dtype=dtype))

    def __getitem__(self, name: str):
        return getattr(self, name)

    def __contains__(self, name: str) -> bool:
        return name in self._parameters or name in self._modules or \
            name in self._buffers


def init(module: nn.Module, specs: dict,
         generator: torch.Generator) -> None:
    """Draw every parameter of ``module`` named by ``specs``' paths, in
    the tree's order, from ``generator`` (on the parameters' device).
    The draws are not JAX's: only their distribution matches."""
    for path, s in leaves(specs):
        init_(module.get_parameter(path), s, generator)


def count(specs) -> int:
    return sum(math.prod(s.shape) for _, s in leaves(specs))
