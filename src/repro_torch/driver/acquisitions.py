"""Acquisition functions: how a candidate pool is ranked for evaluation.

The two-stage strategies (``SurrogateGuided``, the portfolio) screen a
cheap candidate pool with a learned cost model and send only the most
promising ``k`` schedules to the expensive evaluator. *How* "promising"
is scored is the acquisition function — the Bayesian-optimization seam
the autotuning literature (OptiML, the Memeti et al. survey) builds
on. This module makes it a registry:

``argmin_topk`` (default)
    Rank by predicted time alone — exactly the screening
    ``SurrogateGuided`` has always done (stable argsort of the
    surrogate's predictions). Pure exploitation of the model's mean.

``ucb``
    Lower confidence bound ``mu - beta * sigma`` (we *minimize* time,
    so optimism-in-the-face-of-uncertainty subtracts the deviation).
    ``beta=0`` reproduces ``argmin_topk`` ordering.

``expected_improvement``
    Classic EI against the best observed time:
    ``EI = (best - mu - xi) * Phi(z) + sigma * phi(z)`` with
    ``z = (best - mu - xi) / sigma``; candidates are ranked by ``-EI``
    (all scores here are *lower-is-better*). Candidates with zero
    predicted deviation fall back to their plain improvement
    ``max(best - mu - xi, 0)``.

Uncertainty comes from :func:`predict_with_std`: surrogates that
expose ``predict_with_std(schedules) -> (mu, sd)`` (the boosted
ensemble's per-tree disagreement,
:meth:`repro_torch.rules.boost.GradientBoostedSurrogate.predict_with_std`)
report real deviations; anything else (e.g. the ridge model) gets
``sd = 0``, which degrades every acquisition to ``argmin_topk``
ordering instead of failing.

Every acquisition is a callable

    acq(surrogate, pool, best=None) -> (scores, mu)

where ``scores`` ranks the pool (lower = evaluate first; callers take
``np.argsort(scores, kind="stable")[:k]``) and ``mu`` is the
predicted mean time per candidate — returned alongside so screening-
quality logs always record the *prediction*, never the acquisition
score. The registry stores factories: ``make_acquisition("ucb",
beta=0.5)`` builds the configured callable.

The JAX package's ``repro/driver/acquisitions.py``.
"""
from __future__ import annotations

import math
from typing import Callable, Protocol, Sequence, runtime_checkable

import numpy as np


@runtime_checkable
class Surrogate(Protocol):
    """What an acquisition needs from a cost model."""

    def predict(self, schedules: Sequence) -> np.ndarray: ...


AcquisitionFn = Callable[..., "tuple[np.ndarray, np.ndarray]"]


def predict_with_std(surrogate, schedules
                     ) -> tuple[np.ndarray, np.ndarray]:
    """(predicted mean, predicted deviation) per schedule.

    Uses the surrogate's own ``predict_with_std`` when it has one;
    otherwise the plain prediction with zero deviation — so
    uncertainty-aware acquisitions degrade to mean-ranking (never
    crash) on surrogates that cannot quantify uncertainty.
    """
    fn = getattr(surrogate, "predict_with_std", None)
    if fn is not None:
        mu, sd = fn(schedules)
        return (np.asarray(mu, dtype=np.float64),
                np.asarray(sd, dtype=np.float64))
    mu = np.asarray(surrogate.predict(schedules), dtype=np.float64)
    return mu, np.zeros_like(mu)


# -- the built-in acquisitions ------------------------------------------------

def argmin_topk() -> AcquisitionFn:
    """Rank by predicted time — the original two-stage screening."""

    def acq(surrogate, pool, best: float | None = None):
        mu = np.asarray(surrogate.predict(pool), dtype=np.float64)
        return mu, mu

    acq.name = "argmin_topk"
    return acq


def ucb(beta: float = 1.0) -> AcquisitionFn:
    """Lower confidence bound ``mu - beta * sd`` (minimization UCB)."""
    if beta < 0.0:
        raise ValueError("beta must be >= 0")

    def acq(surrogate, pool, best: float | None = None):
        mu, sd = predict_with_std(surrogate, pool)
        return mu - beta * sd, mu

    acq.name = "ucb"
    return acq


_SQRT2 = math.sqrt(2.0)
_INV_SQRT_2PI = 1.0 / math.sqrt(2.0 * math.pi)
_erf = np.vectorize(math.erf, otypes=[np.float64])


def _norm_cdf(z: np.ndarray) -> np.ndarray:
    return 0.5 * (1.0 + _erf(z / _SQRT2))


def _norm_pdf(z: np.ndarray) -> np.ndarray:
    return _INV_SQRT_2PI * np.exp(-0.5 * z * z)


def expected_improvement(xi: float = 0.0,
                         relative: bool = True) -> AcquisitionFn:
    """Expected improvement over the best observed time.

    ``xi`` shifts the improvement threshold: positive trades more
    exploration (a candidate must promise to beat the incumbent by a
    margin before its mean counts), negative leans exploitation —
    inflating every candidate's nominal improvement pushes the
    ``Phi(z)`` term toward 1, so the ranking approaches mean-first with
    uncertainty as the tie-breaker (the "greedy EI" operating point).
    With
    ``relative=True`` (default) ``xi`` is a fraction of the incumbent
    (``margin = xi * |best|``), so one setting transfers across graphs
    whose makespans differ by orders of magnitude; ``relative=False``
    reads ``xi`` in absolute time units.

    With no observed best yet (or a surrogate reporting zero deviation
    everywhere) the ordering falls back to plain predicted-time
    ranking, so warm starts behave like ``argmin_topk``.
    """

    def acq(surrogate, pool, best: float | None = None):
        mu, sd = predict_with_std(surrogate, pool)
        if best is None or not np.any(sd > 0.0):
            return mu, mu
        margin = xi * abs(best) if relative else xi
        imp = best - mu - margin
        pos = sd > 0.0
        z = np.where(pos, imp / np.where(pos, sd, 1.0), 0.0)
        ei = np.where(pos,
                      imp * _norm_cdf(z) + sd * _norm_pdf(z),
                      np.maximum(imp, 0.0))
        scores = -ei
        # Zero EI (deterministic candidates past the incumbent) cannot
        # rank within itself — every such candidate scores exactly 0,
        # which a stable argsort would resolve by pool order. Fall back
        # to predicted-time order *behind* every positive-EI candidate
        # (their scores are < 0) instead of spending budget pool-first.
        flat = ei <= 0.0
        if np.any(flat):
            mu_f = mu[flat]
            span = float(mu_f.max() - mu_f.min())
            scores[flat] = 1.0 + (mu_f - mu_f.min()) / (span or 1.0)
        return scores, mu

    acq.name = "expected_improvement"
    return acq


# -- the registry -------------------------------------------------------------

ACQUISITIONS: dict[str, Callable[..., AcquisitionFn]] = {}
"""Acquisition factories: name -> ``factory(**kwargs) -> acq_fn``."""


def register_acquisition(name: str,
                         factory: Callable[..., AcquisitionFn]) -> None:
    """Add an acquisition factory to the :data:`ACQUISITIONS` registry.

    Factories are called as ``factory(**kwargs)`` and must return a
    callable ``acq(surrogate, pool, best=None) -> (scores, mu)`` with
    lower-is-better ``scores`` aligned to ``pool``.
    """
    ACQUISITIONS[name] = factory


register_acquisition("argmin_topk", argmin_topk)
register_acquisition("ucb", ucb)
register_acquisition("expected_improvement", expected_improvement)


def make_acquisition(acquisition: str = "argmin_topk",
                     **kwargs) -> AcquisitionFn:
    """Construct an acquisition function by registry name."""
    try:
        factory = ACQUISITIONS[acquisition]
    except KeyError:
        raise ValueError(
            f"unknown acquisition {acquisition!r}; registered: "
            f"{sorted(ACQUISITIONS)}") from None
    return factory(**kwargs)


def resolve_acquisition(acquisition, kwargs: dict | None
                        ) -> AcquisitionFn:
    """Registry name -> built callable; pre-built callables pass through.

    The one name-or-callable resolution shared by every acquisition
    consumer (``SurrogateGuided``, ``SearchDriver``): ``kwargs`` only
    apply to registry names — combining them with a pre-built callable
    raises instead of being silently dropped.
    """
    if isinstance(acquisition, str):
        return make_acquisition(acquisition, **(kwargs or {}))
    if kwargs is not None:
        raise ValueError(
            "acquisition_kwargs only applies when acquisition is a "
            "registry name, not a pre-built callable")
    return acquisition
