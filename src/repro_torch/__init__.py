"""PyTorch/CUDA port of the paper's loop (the JAX package ``repro`` is
the reference).

    Graph (core.dag) -> MCTS (search.mcts) over (order x stream) schedules
        -> each schedule expanded with Table III syncs (core.sync) and
           measured on real CUDA streams and events (core.executor under
           engine.wallclock), running the distributed SpMV
           (spmv.distributed) through hand-written Hopper kernels
           (kernels.spmv, kernels.pack; sources in csrc/)
        -> class labels (rules.labels) -> features (core.features)
        -> Algorithm 1 (rules.trees) -> design rules (rules.rulesets)

Entry points take ``device=None``, meaning ``"cuda"``; without a card
they raise unless ``device="cpu"`` is passed (see :mod:`.device`).
"""
