"""Benchmarking protocol (paper §III-C3).

A *measurement* = keep invoking the program (each invocation is a
*sample*) until t_measure = 0.01 s has elapsed; the program time estimate
is elapsed / n_samples. The port's ranks all run in one process on one
card, so the max across ranks is implicit.

The JAX package's ``repro/core/bench.py`` (:func:`measure`,
:data:`T_MEASURE_S`), with :func:`measure_cuda` beside it: the same
window on the card, drained once before the window opens and once
before its end is read.
"""
from __future__ import annotations

import time
from typing import Callable

import torch

T_MEASURE_S = 0.01


def measure(fn: Callable[[], object], t_measure_s: float = T_MEASURE_S,
            min_samples: int = 1) -> float:
    """One paper-style measurement of ``fn``; returns seconds/sample."""
    # Warm-up (compilation etc.) excluded, as any wall-clock benchmark must.
    fn()
    n = 0
    start = time.perf_counter()
    elapsed = 0.0
    while elapsed < t_measure_s or n < min_samples:
        fn()
        n += 1
        elapsed = time.perf_counter() - start
    return elapsed / n


def measure_cuda(fn: Callable[[], object], device: torch.device,
                 t_measure_s: float = T_MEASURE_S,
                 min_samples: int = 1) -> float:
    """:func:`measure` on ``device``: seconds/sample of ``fn`` invoked
    back to back for ``t_measure_s``.

    The device is drained after the warm-up call, so the window opens on
    an idle card, and again after the last sample, before the clock is
    read, so the window holds all the device work its samples enqueued.
    Between the two the samples run back to back (a schedule holds its
    own host syncs, so each sample is a whole program run). On the CPU
    there is nothing to drain.
    """
    def drain() -> None:
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    fn()
    drain()
    n = 0
    start = time.perf_counter()
    elapsed = 0.0
    while elapsed < t_measure_s or n < min_samples:
        fn()
        n += 1
        elapsed = time.perf_counter() - start
    drain()
    return (time.perf_counter() - start) / n
