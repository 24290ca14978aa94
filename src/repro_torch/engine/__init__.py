"""Evaluation backends behind one memoized contract, selected by name.

Backends:

  ``sim``         the serial analytic reference: one discrete-event
                  simulation (:mod:`repro_torch.core.costmodel`) per
                  canonical-unique schedule, under a
                  :class:`~repro_torch.core.costmodel.Machine` (the
                  H100's constants by default).
  ``vectorized``  numpy batch simulator, bit-identical to ``sim``.
  ``pool``        ``sim``'s math sharded over a process pool; cache and
                  accounting stay in the parent, results bit-identical.
  ``wallclock``   measured on the device: the executor on real streams
                  and events for schedule spaces
                  (:class:`ExecutorEvaluator`), the kernel runner sweep
                  for parameter spaces (:class:`KernelWallclockEvaluator`);
                  :func:`make_evaluator` dispatches on the space.
  ``rpc``         evaluation as a service: miss batches sharded over a
                  fleet of :mod:`repro_torch.engine.server` hosts with
                  pipelined dispatch, retry/hedging fault tolerance,
                  and local fallback — bit-identical to ``sim``.

The four analytic backends (``sim``, ``vectorized``, ``pool``, ``rpc``)
run on the host and take no ``device``.
"""
from __future__ import annotations

from repro_torch.core.costmodel import Machine
from repro_torch.core.dag import Graph
from repro_torch.engine.base import (BatchEvaluator, EvalBatch, EvaluatorBase,
                                     canonical_key)
from repro_torch.engine.params import KernelWallclockEvaluator
from repro_torch.engine.pool import PoolEvaluator
from repro_torch.engine.rpc import (RpcError, RpcEvaluator, RpcHandshakeError,
                                    RpcProtocolError)
from repro_torch.engine.store import EvalStore, store_fingerprint
from repro_torch.engine.vectorized import (GraphTables, VectorizedEvaluator,
                                           simulate_batch, simulate_encoded)
from repro_torch.engine.wallclock import (ExecutorEvaluator,
                                          assert_outputs_close,
                                          demo_spmv_impls, reference_schedule)
from repro_torch.space.base import DesignSpace, as_space
from repro_torch.space.params import ParamSpace

BACKENDS: dict[str, type[EvaluatorBase]] = {
    "sim": BatchEvaluator,
    "vectorized": VectorizedEvaluator,
    "pool": PoolEvaluator,
    "wallclock": ExecutorEvaluator,
    "rpc": RpcEvaluator,
}


def __getattr__(name: str):
    # The server module is imported lazily so that
    # ``python -m repro_torch.engine.server`` does not trip runpy's
    # already-in-sys.modules warning (and a bare ``import
    # repro_torch.engine`` never pays for the subprocess/CLI machinery).
    if name in ("EvalServer", "ServerProcess", "spawn_server_process"):
        from repro_torch.engine import server

        return getattr(server, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def register_backend(name: str, cls: type[EvaluatorBase]) -> None:
    """Add (or replace) an evaluation backend under ``name``."""
    if not (isinstance(cls, type) and issubclass(cls, EvaluatorBase)):
        raise TypeError(f"{cls!r} is not an EvaluatorBase subclass")
    BACKENDS[name] = cls


def make_evaluator(graph: "Graph | DesignSpace", backend: str = "wallclock",
                   *, machine: Machine | None = None,
                   **kwargs) -> EvaluatorBase:
    """Construct the named evaluation backend for ``graph`` (a graph or
    a design space).

    The default backend is ``"wallclock"``, where the JAX package's is
    ``"sim"``: the port's main path measures on the card. ``machine``
    is the analytic model's constants (the H100's when ``None``).
    ``kwargs`` are backend-specific (``n_workers`` for ``pool``;
    ``impls``/``env``/``reset``/``t_measure_s`` for schedule spaces and
    ``repeats``, ``warmup``, ``check_values``, ``compile_mode`` for
    parameter spaces under ``wallclock``; ``device`` for both; ``hosts``
    for ``rpc``) plus the
    shared base-layer knobs: ``noise_sigma`` / ``noise_seed`` and the
    persistent store (``store=`` a shared :class:`EvalStore`, or
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
    return cls(space, machine=machine, **kwargs)


__all__ = ["BACKENDS", "make_evaluator", "register_backend",
           "EvaluatorBase", "BatchEvaluator", "EvalBatch", "canonical_key",
           "VectorizedEvaluator",
           "GraphTables", "simulate_batch", "simulate_encoded",
           "PoolEvaluator", "RpcEvaluator", "RpcError", "RpcHandshakeError",
           "RpcProtocolError", "EvalServer", "ServerProcess",
           "spawn_server_process", "EvalStore", "store_fingerprint",
           "ExecutorEvaluator", "KernelWallclockEvaluator",
           "assert_outputs_close", "demo_spmv_impls", "reference_schedule",
           "Machine"]
