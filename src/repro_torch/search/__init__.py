"""Search strategies and the search loop."""
from repro_torch.search.mcts import MCTSSearch
from repro_torch.search.pipeline import SearchResult, run_search

__all__ = ["MCTSSearch", "SearchResult", "run_search"]
