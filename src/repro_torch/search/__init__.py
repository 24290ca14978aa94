"""Search strategies and the search entry point.

One strategy protocol (:class:`SearchStrategy`, with the pool extension
:class:`PoolSearchStrategy`); strategies from exhaustive enumeration and
the paper's MCTS to the surrogate-screened two-stage search and the
greedy→MCTS→surrogate portfolio; the evaluation engine's names
(:mod:`repro_torch.engine`, re-exported); and :func:`run_search`, the thin
wrapper over :class:`repro_torch.driver.SearchDriver` that turns any
strategy × evaluator into the (features, labels, times) dataset the
rules pipeline consumes.
"""
from repro_torch.engine import (BACKENDS, BatchEvaluator, EvaluatorBase,
                                ExecutorEvaluator, PoolEvaluator,
                                VectorizedEvaluator, canonical_key,
                                make_evaluator, register_backend)
from repro_torch.search.mcts import MCTSSearch
from repro_torch.search.pipeline import SearchResult, run_search
from repro_torch.search.strategy import (ExhaustiveSearch, GreedyCostModel,
                                         PoolSearchStrategy, RandomSearch,
                                         SearchStrategy, eligible_items,
                                         random_schedule)
from repro_torch.search.surrogate import (SURROGATES,
                                          GradientBoostedSurrogate,
                                          PortfolioSearch, RidgeSurrogate,
                                          SurrogateGuided, make_surrogate,
                                          register_surrogate, spearman)

__all__ = [
    "BACKENDS", "BatchEvaluator", "EvaluatorBase", "ExecutorEvaluator",
    "PoolEvaluator", "VectorizedEvaluator", "canonical_key",
    "make_evaluator", "register_backend",
    "MCTSSearch", "SearchResult", "run_search",
    "ExhaustiveSearch", "GreedyCostModel", "PoolSearchStrategy",
    "RandomSearch", "SearchStrategy", "eligible_items", "random_schedule",
    "SURROGATES", "GradientBoostedSurrogate", "PortfolioSearch",
    "RidgeSurrogate", "SurrogateGuided", "make_surrogate",
    "register_surrogate", "spearman",
]
