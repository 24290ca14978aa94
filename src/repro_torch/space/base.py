"""The :class:`DesignSpace` protocol: what a search needs from a space.

The JAX package's ``repro/space/base.py`` (the protocol and the name
registry), trimmed to what the port's stack uses:

  * **identity** — ``encode_batch`` turns candidates into canonical
    int32 rows whose bytes are the cache/store keys (stream-bijection
    normal form for schedules, value indices for parameter grids);
    ``candidate_key``/``tie_key`` are the per-candidate hashable and
    total-order forms.
  * **moves** — sequential construction (``moves``/``finalize``, what
    MCTS expands), whole-candidate sampling (``random_candidate``) and
    full enumeration (``enumerate_candidates``) for the strategies.
  * **featurization** — ``feature_basis``/``featurize``/
    ``apply_features`` produce the binary feature matrices the rules
    pipeline distills (order/stream pairs for schedules, value
    thresholds for parameters).
  * **evaluation support** — ``fingerprint`` is the persistent-store
    content address (:mod:`repro_torch.engine.store`), ``durations``
    the analytic per-op table, ``analytic_cost`` the simulation
    objective where one exists.

Left out: ``decode_batch`` and ``feature_universe`` (only the
out-of-core sinks need them) and ``mutate`` (only the surrogate
strategies need it).

:func:`as_space` is the compatibility seam: every public entry point
(``run_search``, ``make_evaluator``, ``distill``, the strategies)
accepts a :class:`~repro_torch.core.dag.Graph` or a
:class:`DesignSpace` and normalizes through it.
"""
from __future__ import annotations

import random
from typing import Any, Callable, Iterator, Sequence

import numpy as np

from repro_torch.core.dag import Graph


class DesignSpace:
    """A searchable space of candidate designs (see module docstring).

    Subclasses implement the identity block (``encode_batch``,
    ``candidate_key``, ``tie_key``), the move block (``moves``,
    ``move_key``, ``finalize``, ``candidate_moves``,
    ``enumerate_candidates``), the featurization block
    (``feature_basis``, ``featurize``, ``apply_features``) and
    ``fingerprint``; ``random_candidate`` has a generic default built on
    the move block, and ``durations`` / ``analytic_cost`` default to "no
    analytic model".
    """

    name: str = "abstract"

    # -- identity ----------------------------------------------------------
    def encode_batch(self, candidates: Sequence[Any]
                     ) -> tuple[list[bytes], np.ndarray]:
        """(cache keys, canonical int32 encoding) for a candidate batch.

        Row ``i`` of the array is candidate ``i``'s canonical encoding;
        ``keys[i]`` is that row's bytes — the memo-cache and persistent-
        store key. Must be a pure function of the candidate (never of
        batch order or history).
        """
        raise NotImplementedError

    def candidate_key(self, candidate: Any):
        """Hashable canonical identity of one candidate (dedup key)."""
        raise NotImplementedError

    def tie_key(self, candidate: Any) -> tuple:
        """Total order on canonical encodings (deterministic
        tie-breaking for ``SearchResult.best``)."""
        raise NotImplementedError

    def describe(self, candidate: Any) -> str:
        """Human-readable one-liner for reports and logs."""
        return repr(candidate)

    # -- moves -------------------------------------------------------------
    def moves(self, prefix: list) -> list:
        """Legal next moves extending ``prefix`` (empty = complete).

        Sequential construction is the one move model every strategy
        shares: MCTS expands over it, rollouts/mutations complete
        through it, and a complete prefix ``finalize``\\ s into a
        candidate. Every candidate built through ``moves`` must be
        canonical (its ``candidate_key`` equals that of any equivalent
        construction).
        """
        raise NotImplementedError

    def move_key(self, move) -> tuple | Any:
        """Hashable identity of one move (MCTS child key)."""
        raise NotImplementedError

    def finalize(self, prefix: list) -> Any:
        """The candidate a complete move prefix denotes."""
        raise NotImplementedError

    def candidate_moves(self, candidate: Any) -> Sequence:
        """The move sequence that constructs ``candidate`` (the inverse
        of ``finalize``; MCTS path materialization)."""
        raise NotImplementedError

    def enumerate_candidates(self) -> Iterator[Any]:
        """Every candidate, in the space's canonical order."""
        raise NotImplementedError

    def random_candidate(self, rng: random.Random) -> Any:
        """Uniform random completion through ``moves`` (rollout policy):
        one ``rng.choice`` per move, as the JAX package consumes it."""
        prefix: list = []
        while True:
            options = self.moves(prefix)
            if not options:
                return self.finalize(prefix)
            prefix.append(rng.choice(options))

    # -- featurization -----------------------------------------------------
    def feature_basis(self):
        """Incremental featurizer: ``.add(candidates)`` absorbs,
        ``.matrix()`` emits the constant-pruned
        :class:`~repro_torch.core.features.FeatureMatrix`."""
        raise NotImplementedError

    def featurize(self, candidates: Sequence[Any]):
        """Constant-pruned feature matrix for a candidate corpus.

        Raises :class:`~repro_torch.core.features.
        DegenerateFeatureSpaceError` when no discriminating feature
        survives pruning.
        """
        raise NotImplementedError

    def apply_features(self, candidates: Sequence[Any],
                       features: list) -> np.ndarray:
        """Evaluate an explicit feature list on new candidates
        (classify-the-full-space path)."""
        raise NotImplementedError

    # -- evaluation support ------------------------------------------------
    def durations(self, machine) -> dict:
        """Per-op analytic duration table (empty when inapplicable)."""
        return {}

    def fingerprint(self, machine, durations: dict,
                    objective: str) -> bytes:
        """16-byte content address of *what a stored time means* in
        this space (see :mod:`repro_torch.engine.store`). Everything
        that determines the ``canonical key -> time`` mapping must be
        hashed; spaces with different candidates, problem instances,
        machines, or objectives must never collide.
        """
        raise NotImplementedError

    def analytic_cost(self, candidate: Any, machine,
                      durations: dict) -> float:
        """The analytic-model objective, where the space has one."""
        raise NotImplementedError(
            f"design space {self.name!r} has no analytic cost model; "
            "evaluate it with the wallclock backend")


# -- the registry -------------------------------------------------------------

SPACES: dict[str, Callable[..., DesignSpace]] = {}
"""Design-space factories: name -> ``factory(**kwargs) -> DesignSpace``."""


def register_space(name: str,
                   factory: Callable[..., DesignSpace]) -> None:
    """Add (or replace) a design-space factory under ``name``."""
    SPACES[name] = factory


def make_space(name: str, **kwargs) -> DesignSpace:
    """Construct a registered design space by name."""
    try:
        factory = SPACES[name]
    except KeyError:
        raise ValueError(
            f"unknown design space {name!r}; registered: "
            f"{sorted(SPACES)}") from None
    return factory(**kwargs)


def as_space(obj, n_streams: int | None = None) -> DesignSpace:
    """Normalize ``Graph``-or-``DesignSpace`` to a :class:`DesignSpace`.

    A :class:`~repro_torch.core.dag.Graph` wraps into a
    :class:`~repro_torch.space.schedule.ScheduleSpace` (``n_streams``
    defaults to 2, the paper's setting); a space passes through
    (``n_streams`` must then be None — the space already fixed it).
    """
    if isinstance(obj, DesignSpace):
        if n_streams is not None:
            raise TypeError(
                f"n_streams={n_streams} conflicts with the explicit "
                f"design space {obj.name!r} (which already fixes its "
                "move structure); pass one or the other")
        return obj
    if isinstance(obj, Graph):
        from repro_torch.space.schedule import ScheduleSpace
        return ScheduleSpace(obj, 2 if n_streams is None else n_streams)
    raise TypeError(
        f"expected a Graph or DesignSpace, got {type(obj).__name__!r}")
