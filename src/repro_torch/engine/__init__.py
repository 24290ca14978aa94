"""Evaluation backends behind one memoized contract, selected by name.

``wallclock`` measures on the device: the executor on real streams and
events for schedule spaces (:class:`ExecutorEvaluator`), the kernel
runner sweep for parameter spaces (:class:`KernelWallclockEvaluator`);
:func:`make_evaluator` dispatches on the space. The JAX package's
analytic backends (``sim``, ``vectorized``, ``pool``) and the ``rpc``
service are not ported.
"""
from __future__ import annotations

from repro_torch.core.dag import Graph
from repro_torch.engine.base import EvaluatorBase
from repro_torch.engine.params import KernelWallclockEvaluator
from repro_torch.engine.store import EvalStore, store_fingerprint
from repro_torch.engine.wallclock import (ExecutorEvaluator,
                                          assert_outputs_close,
                                          reference_schedule)
from repro_torch.space.base import DesignSpace, as_space
from repro_torch.space.params import ParamSpace

BACKENDS: dict[str, type[EvaluatorBase]] = {
    "wallclock": ExecutorEvaluator,
}


def register_backend(name: str, cls: type[EvaluatorBase]) -> None:
    """Add (or replace) an evaluation backend under ``name``."""
    if not (isinstance(cls, type) and issubclass(cls, EvaluatorBase)):
        raise TypeError(f"{cls!r} is not an EvaluatorBase subclass")
    BACKENDS[name] = cls


def make_evaluator(graph: "Graph | DesignSpace", backend: str = "wallclock",
                   **kwargs) -> EvaluatorBase:
    """Construct the named evaluation backend for ``graph`` (a graph or
    a design space).

    ``kwargs`` are backend-specific (``impls``/``env``/``reset`` for
    schedule spaces; ``repeats``, ``warmup``, ``check_values``,
    ``compile_mode`` for parameter spaces; ``device`` for both) plus
    the persistent store (``store=`` a shared :class:`EvalStore`, or
    ``store_path=`` a file the evaluator opens and owns).
    """
    try:
        cls = BACKENDS[backend]
    except KeyError:
        raise ValueError(
            f"unknown evaluation backend {backend!r}; available: "
            f"{sorted(BACKENDS)}") from None
    space = as_space(graph)
    if backend == "wallclock" and isinstance(space, ParamSpace):
        # Parameter spaces measure through their KernelRunner, not the
        # schedule executor; same registry name, same contract.
        cls = KernelWallclockEvaluator
    return cls(space, **kwargs)


__all__ = ["BACKENDS", "make_evaluator", "register_backend",
           "EvaluatorBase", "EvalStore", "store_fingerprint",
           "ExecutorEvaluator", "KernelWallclockEvaluator",
           "assert_outputs_close", "reference_schedule"]
