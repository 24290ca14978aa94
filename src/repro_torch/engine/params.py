"""Param-space wall-clock backend: measure the port's own kernels.

The counterpart of :mod:`repro_torch.engine.wallclock` for
:class:`~repro_torch.space.params.ParamSpace` candidates: each
candidate's parameter assignment is handed to the space's
:class:`~repro_torch.space.params.KernelRunner` (``build(params)`` → a
zero-argument callable on a fixed problem instance). Memo cache,
hit/miss meters, persistent :class:`~repro_torch.engine.store.EvalStore`
warm starts and salvage are inherited from
:class:`~repro_torch.engine.base.EvaluatorBase`, so a kernel autotune
run is driven, deduped, budgeted and warm-started exactly like a
schedule search.

Measurement protocol per canonical-unique candidate:

  1. **gate phase** — build every candidate's runner and run it once
     (the device drained after it), holding its outputs to
     ``runner.reference()`` (``rtol``/``atol``; the error names the
     candidate). With ``compile_mode="batch"`` (the default) this
     covers the whole batch before any timing starts, so the first
     call's nvcc build and module load never land in a timing;
     ``compile_mode="per_candidate"`` interleaves gate and timing.
  2. **timing phase** — ``warmup - 1`` further calls, then ``repeats``
     timed calls, each with ``torch.cuda.synchronize()`` on both sides
     of the host clock; the median is kept.

The objective key names the platform (the card and its compute
capability, or ``cpu``) in place of the JAX package's
``jax.default_backend()``, and the kernels' build
(:func:`repro_torch.kernels.build.source_hash`), so sweeps on different
hardware or on an earlier build of the kernels never warm-start each
other. The JAX package's ``repro/engine/params.py`` without its
telemetry spans and the TPU ``Machine``.
"""
from __future__ import annotations

import statistics
import time
from typing import Sequence

import numpy as np
import torch

from repro_torch.device import platform_string, resolve_device
from repro_torch.engine.base import EvaluatorBase
from repro_torch.engine.wallclock import (_as_output_map,
                                          assert_outputs_close)
from repro_torch.kernels.build import source_hash
from repro_torch.space.params import ParamSpace


class KernelWallclockEvaluator(EvaluatorBase):
    """Wall-clock evaluation of a :class:`ParamSpace` with a runner;
    ``device=None`` means CUDA (and raises without it)."""

    backend = "wallclock"

    def __init__(self, space: ParamSpace, *, repeats: int = 5,
                 warmup: int = 1, check_values: bool = True,
                 rtol: float = 1e-4, atol: float = 1e-6,
                 compile_mode: str = "batch",
                 device: "str | torch.device | None" = None,
                 **base_kwargs):
        super().__init__(space, **base_kwargs)
        runner = getattr(self.space, "runner", None)
        if runner is None:
            raise ValueError(
                f"design space {self.space.name!r} has no KernelRunner "
                "attached; the param-space wallclock backend needs "
                "runner= on the ParamSpace (build + reference)")
        if compile_mode not in ("batch", "per_candidate"):
            raise ValueError(
                f"compile_mode must be 'batch' or 'per_candidate', "
                f"got {compile_mode!r}")
        self.device = resolve_device(device)
        self.platform = platform_string(self.device)
        self.runner = runner
        self.repeats = max(1, repeats)
        self.warmup = max(1, warmup)
        self.check_values = check_values
        self.rtol = rtol
        self.atol = atol
        self.compile_mode = compile_mode
        self.n_checked = 0
        self._reference: dict | None = None

    def objective_key(self) -> str:
        """Kernel wall clock on this platform under this protocol, of
        this build of the kernels (``compile_mode`` moves the build
        around but times the same quantity, so it is not part of the
        key)."""
        return (f"kernel-wallclock:platform={self.platform}:"
                f"repeats={self.repeats}:warmup={self.warmup}:"
                f"build={source_hash()}")

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _call(self, run):
        out = run()
        self._sync()
        return out

    def _timed(self, run) -> float:
        self._sync()
        t0 = time.perf_counter()
        run()
        self._sync()
        return time.perf_counter() - t0

    def _reference_outputs(self) -> dict:
        if self._reference is None:
            self._reference = _as_output_map(
                self._call(self.runner.reference))
        return self._reference

    def _check(self, out, candidate) -> None:
        assert_outputs_close(
            out, self._reference_outputs(), rtol=self.rtol,
            atol=self.atol,
            context=(f" for candidate "
                     f"({self.space.describe(candidate)}) — kernel "
                     "output failed the value-correctness gate"))
        self.n_checked += 1

    def _measure_batch(self, candidates: Sequence,
                       encoded: np.ndarray | None = None) -> list[float]:
        out: list[float] = []
        try:
            runs = []
            for cand in candidates:
                run = self.runner.build(self.space.as_dict(cand))
                runs.append(run)
                if self.compile_mode == "batch":
                    # Build + gate the whole batch ahead of timing.
                    result = self._call(run)
                    if self.check_values:
                        self._check(result, cand)
            for cand, run in zip(candidates, runs):
                if self.compile_mode == "per_candidate":
                    result = self._call(run)
                    if self.check_values:
                        self._check(result, cand)
                for _ in range(self.warmup - 1):
                    self._call(run)
                out.append(statistics.median(
                    self._timed(run) for _ in range(self.repeats)))
        finally:
            # If a candidate fails the gate mid-batch, the timings
            # already paid for are banked (memo cache + store) and
            # metered as misses on their next lookup.
            if out and len(out) < len(candidates):
                _, encoded = self.space.encode_batch(candidates[:len(out)])
                self._salvage_partial(encoded, out)
        return out
