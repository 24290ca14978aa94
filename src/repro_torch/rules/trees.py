"""Vectorized CART training — the shared tree kernel of the rules
subsystem (paper §IV-C, Algorithm 1).

The subset of scikit-learn's ``DecisionTreeClassifier`` the paper
uses: CART with gini impurity,
``class_weight='balanced'``, ``max_leaf_nodes`` (best-first growth by
weighted impurity decrease, like sklearn) and ``max_depth``.

The split finder comes in two interchangeable implementations:

``splitter="vectorized"`` (default)
    Sort-based: every feature column is analysed **once** per dataset
    (:class:`Presort`, reused across the whole Algorithm-1
    ``max_leaf_nodes`` sweep and across boosting rounds) and all
    thresholds of all features are scored per node as numpy array ops.
    Binary features — the paper's entire §IV-B order/stream space —
    take a matmul fast path: per node, one (rows × features) indicator
    gather and one BLAS product against the one-hot classes yield every
    candidate's class histogram, with no per-node sorting state at
    all. Multi-valued features keep presorted row orders (argsorted
    once, then *filtered* down the tree, never re-sorted) and score
    candidates from cumulative class counts gathered only at
    value-boundary positions.

``splitter="loop"``
    The per-candidate Python loop (one masked histogram pair per
    threshold), kept as the reference the vectorized splitter is held
    to.

Both splitters produce **bit-identical trees**: class histograms are
computed as ``class_weight * integer_count`` (exact — never an
order-dependent float accumulation), every reduction over the class
axis runs in ascending class order in both implementations, and ties
in gain resolve to the lowest (feature, threshold) candidate. The same
kernels score variance-reduction splits for :class:`RegressionTree`,
the base learner of :class:`repro_torch.rules.boost.GradientBoostedSurrogate`.

The tree is intentionally allowed to overfit (paper §IV-C): it
describes the explored design space; generalization is measured
separately (Table V).

The JAX package's ``repro/rules/trees.py``, whole: the dense CART above,
:class:`RegressionTree` (the boosted surrogate's base learner) and the
out-of-core half — :class:`ClassCountHistogram`, :class:`HistogramGrower`,
:func:`fit_from_histograms`, :func:`algorithm1_from_histograms` — which
grows the same tree from blockwise class-count histograms without
holding the feature matrix.
"""
from __future__ import annotations

import dataclasses
import heapq
import itertools

import numpy as np

# Work-chunk size (elements of the (features x node rows) score matrix)
# for the sorted split path: bounds peak memory without changing any
# result (the kernel is elementwise across features).
_FEATURE_BLOCK = 4 * 1024 * 1024
# float32 holds integer counts exactly below 2^24; larger nodes use the
# float64 indicator copy in the binary matmul path.
_F32_EXACT = 1 << 24


def _wsum(vec) -> float:
    """Sum in ascending index order.

    Both splitters reduce over the class axis with this exact
    (sequential) order, so their per-candidate gains — and therefore
    the trees they grow — are bit-identical; ``np.sum`` reorders by
    memory layout and would break that.
    """
    tot = 0.0
    for x in vec:
        tot += float(x)
    return tot


def _gini(weighted_counts) -> float:
    tot = _wsum(weighted_counts)
    if tot <= 0:
        return 0.0
    acc = 0.0
    for c in weighted_counts:
        p = float(c) / tot
        acc += p * p
    return 1.0 - acc


class Presort:
    """Per-dataset feature analysis shared across tree fits.

    Built once per feature matrix — the expensive O(d·n·log n) part of
    sort-based CART — and reused by every ``train(max_leaf_nodes)``
    trial of :func:`algorithm1` and every boosting round of a
    gradient-boosted ensemble (only labels/residuals change between
    those fits). Holds:

    * ``order`` / ``ranks`` — per-feature stable argsort and dense
      value ranks (equal values share a rank), restricted to the
      multi-valued features (``nb_cols``) for node-level split scoring;
    * ``bin_cols`` / ``bin_thr`` / ``IBf`` / ``IBd`` — the binary
      features, their single candidate threshold (midpoint of the two
      observed values), and the 0/1 indicator matrix of the upper
      value in float32/float64 for exact BLAS count histograms;
    * constant features appear in neither set — no splitter can use
      them (the loop reference skips them the same way).
    """

    def __init__(self, X: np.ndarray):
        X = np.asarray(X, dtype=np.float64)
        if X.ndim != 2:
            raise ValueError(f"X must be 2-D, got shape {X.shape}")
        self.X = np.ascontiguousarray(X)
        self.XT = np.ascontiguousarray(self.X.T)
        n, d = self.X.shape
        self.order = np.argsort(self.XT, axis=1, kind="stable") \
            .astype(np.int32)
        # Dense per-feature value ranks: equal values share a rank, so
        # split-candidate boundaries are int32 comparisons instead of
        # float64 gathers.
        V = np.take_along_axis(self.XT, self.order, axis=1)
        grp = np.zeros(V.shape, dtype=np.int32)
        if n > 1:
            np.cumsum(V[:, 1:] != V[:, :-1], axis=1, dtype=np.int32,
                      out=grp[:, 1:])
        self.ranks = np.empty_like(grp)
        np.put_along_axis(self.ranks, self.order, grp, axis=1)

        max_rank = self.ranks.max(axis=1) if n else \
            np.zeros(d, dtype=np.int32)
        self.bin_cols = np.flatnonzero(max_rank == 1)
        self.nb_cols = np.flatnonzero(max_rank >= 2)
        self.order_nb = np.ascontiguousarray(self.order[self.nb_cols])
        self.ranks_nb = np.ascontiguousarray(self.ranks[self.nb_cols])
        if self.bin_cols.size:
            lo_v = self.XT[self.bin_cols, self.order[self.bin_cols, 0]]
            hi_v = self.XT[self.bin_cols, self.order[self.bin_cols, -1]]
            self.bin_thr = (lo_v + hi_v) / 2.0
            self.IBf = (self.X[:, self.bin_cols] == hi_v[None, :]) \
                .astype(np.float32)
        else:
            self.bin_thr = np.zeros(0, dtype=np.float64)
            self.IBf = np.zeros((n, 0), dtype=np.float32)
        self._IBd: np.ndarray | None = None

    @property
    def IBd(self) -> np.ndarray:
        """float64 indicator copy, built on first use.

        Only the regression path (and >=2^24-row classifier nodes)
        reads it; classification-only workloads never pay the copy.
        """
        if self._IBd is None:
            self._IBd = self.IBf.astype(np.float64)
        return self._IBd

    @property
    def n(self) -> int:
        return self.X.shape[0]

    @property
    def d(self) -> int:
        return self.X.shape[1]


def _check_presort(presort: Presort | None, X: np.ndarray) -> Presort:
    if presort is None:
        return Presort(X)
    if presort.X.shape != np.shape(X):
        raise ValueError(
            f"presort built for shape {presort.X.shape}, got "
            f"{np.shape(X)}")
    return presort


@dataclasses.dataclass
class TreeNode:
    node_id: int
    depth: int
    indices: np.ndarray                  # training rows in this node
    value: np.ndarray                    # weighted class counts
    n_samples: int
    feature: int | None = None           # split feature (None = leaf)
    threshold: float = 0.5
    left: "TreeNode | None" = None
    right: "TreeNode | None" = None

    @property
    def is_leaf(self) -> bool:
        return self.feature is None

    def majority_class(self) -> int:
        return int(np.argmax(self.value))


@dataclasses.dataclass
class _Candidate:
    gain: float
    feature: int
    threshold: float
    left_idx: np.ndarray
    right_idx: np.ndarray
    left_value: np.ndarray
    right_value: np.ndarray


# -- split scoring -----------------------------------------------------------

def _best_split_loop(ps: Presort, y_enc: np.ndarray, class_w: np.ndarray,
                     idx: np.ndarray, parent_imp: float,
                     tot_w: float) -> tuple[float, int, float] | None:
    """Reference split finder: one histogram pair per candidate."""
    K = len(class_w)
    Xn = ps.X[idx]
    yn = y_enc[idx]
    best: tuple[float, int, float] | None = None
    for f in range(Xn.shape[1]):
        col = Xn[:, f]
        vals = np.unique(col)
        if len(vals) < 2:
            continue
        for j in range(len(vals) - 1):
            t = (vals[j] + vals[j + 1]) / 2.0
            mask = col <= t
            lv = class_w * np.bincount(yn[mask], minlength=K)
            rv = class_w * np.bincount(yn[~mask], minlength=K)
            lw, rw = _wsum(lv), _wsum(rv)
            child = (lw * _gini(lv) + rw * _gini(rv)) / tot_w
            gain = tot_w * (parent_imp - child)
            if best is None or gain > best[0]:
                best = (gain, f, float(t))
    return best


def _gini_gains(left_counts: list[np.ndarray],
                right_counts: list[np.ndarray], class_w: np.ndarray,
                parent_imp: float, tot_w: float) -> np.ndarray:
    """Per-candidate weighted impurity decrease from integer counts.

    Two passes over the (small) class axis, both in ascending class
    order: first the left/right total weights, then the gini sums of
    squares (which need the totals) — the exact op order of the loop
    reference's scalar math, applied elementwise.
    """
    K = len(class_w)
    Lw: list[np.ndarray] = []
    Rw: list[np.ndarray] = []
    lw = rw = None
    for k in range(K):
        l_k = class_w[k] * left_counts[k]
        r_k = class_w[k] * right_counts[k]
        Lw.append(l_k)
        Rw.append(r_k)
        lw = l_k if lw is None else lw + l_k
        rw = r_k if rw is None else rw + r_k
    lacc = racc = None
    for k in range(K):
        p = Lw[k] / lw
        q = Rw[k] / rw
        lacc = p * p if lacc is None else lacc + p * p
        racc = q * q if racc is None else racc + q * q
    child = (lw * (1.0 - lacc) + rw * (1.0 - racc)) / tot_w
    return tot_w * (parent_imp - child)


def _best_split_binary(ps: Presort, y_enc: np.ndarray,
                       class_w: np.ndarray, idx: np.ndarray,
                       tcnt: np.ndarray, parent_imp: float,
                       tot_w: float) -> tuple[float, int, float] | None:
    """All binary features of a node in one BLAS product.

    The class histogram right of every binary feature's single
    threshold is ``indicator.T @ onehot(classes)`` — integer counts,
    exact in float32 below 2^24 rows — and the left histogram is the
    node total minus it. No sorting state is touched.
    """
    m = idx.size
    K = len(class_w)
    IB = ps.IBf if m < _F32_EXACT else ps.IBd
    In = IB if m == IB.shape[0] else np.take(IB, idx, axis=0)
    oh = np.zeros((m, K), dtype=IB.dtype)
    oh[np.arange(m), y_enc[idx]] = 1.0
    rcnt = (In.T @ oh).astype(np.int64)              # (d_bin, K) exact
    nright = rcnt.sum(axis=1)
    valid = (nright > 0) & (nright < m)
    if not valid.any():
        return None
    left_counts = [tcnt[k] - rcnt[:, k] for k in range(K)]
    right_counts = [rcnt[:, k] for k in range(K)]
    with np.errstate(invalid="ignore", divide="ignore"):
        # node-constant features divide by an empty side; masked below
        gains = _gini_gains(left_counts, right_counts, class_w,
                            parent_imp, tot_w)
    gains[~valid] = -np.inf
    i = int(np.argmax(gains))            # first max: lowest feature id
    return (float(gains[i]), int(ps.bin_cols[i]), float(ps.bin_thr[i]))


def _best_split_sorted(ps: Presort, y_enc: np.ndarray,
                       class_w: np.ndarray, no: np.ndarray,
                       tcnt: np.ndarray, parent_imp: float,
                       tot_w: float) -> tuple[float, int, float] | None:
    """Multi-valued features: score every threshold from presorted rows.

    ``no`` is the (d_nb, m) matrix of this node's row indices,
    presorted per feature (filtered down from :attr:`Presort.order_nb`,
    never re-sorted). Candidate thresholds sit between consecutive
    distinct sorted values (int32 rank comparisons); gains are
    evaluated **only at those boundary positions** (flat-indexed) from
    cumulative integer class counts.
    """
    d, m = no.shape
    if d == 0 or m < 2:
        return None
    K = len(class_w)
    best: tuple[float, int, float] | None = None
    block = max(1, _FEATURE_BLOCK // m)
    for lo in range(0, d, block):
        o = no[lo:lo + block]
        RV = np.take_along_axis(ps.ranks_nb[lo:lo + block], o, axis=1)
        boundary = RV[:, :-1] != RV[:, 1:]
        ridx = np.flatnonzero(boundary.any(axis=1))  # non-constant here
        if ridx.size == 0:
            continue
        ov = o[ridx]
        rows, cols = np.nonzero(boundary[ridx])      # feature-major order
        C = y_enc[ov]
        # Integer left counts per class at the candidates; the last
        # class is implied (left size minus the others) — all exact.
        left_counts: list[np.ndarray] = []
        csum = None
        for k in range(K - 1):
            cnt = np.cumsum(C == k, axis=1, dtype=np.int32)[rows, cols]
            left_counts.append(cnt)
            csum = cnt.astype(np.int64) if csum is None else csum + cnt
        left_counts.append(cols + 1 - csum)          # left sizes - rest
        right_counts = [tcnt[k] - left_counts[k] for k in range(K)]
        gains = _gini_gains(left_counts, right_counts, class_w,
                            parent_imp, tot_w)
        i = int(np.argmax(gains))        # first max: lowest (f, t) wins
        g = float(gains[i])
        if best is None or g > best[0]:  # strict: earlier chunk wins ties
            fa = lo + int(ridx[rows[i]])     # chunk-local -> nb-global
            pos = int(cols[i])
            a = ps.XT[ps.nb_cols[fa], ov[rows[i], pos]]
            b = ps.XT[ps.nb_cols[fa], ov[rows[i], pos + 1]]
            best = (g, int(ps.nb_cols[fa]), float((a + b) / 2.0))
    return best


def _merge_candidates(a: tuple[float, int, float] | None,
                      b: tuple[float, int, float] | None
                      ) -> tuple[float, int, float] | None:
    """Best of two per-path candidates, loop-ordered on exact ties.

    The loop reference walks features in ascending global index and
    only replaces on strictly larger gain, so an exact tie between the
    binary and sorted paths resolves to the lower feature index.
    """
    if a is None:
        return b
    if b is None:
        return a
    if a[0] != b[0]:
        return a if a[0] > b[0] else b
    return a if a[1] < b[1] else b


# -- regression (variance-reduction) scoring ---------------------------------

def _best_split_reg_binary(ps: Presort, y: np.ndarray, idx: np.ndarray,
                           parent_sse: float, s: float,
                           ss: float) -> tuple[float, int, float] | None:
    m = idx.size
    In = ps.IBd if m == ps.IBd.shape[0] \
        else np.take(ps.IBd, idx, axis=0)
    yn = y if m == ps.IBd.shape[0] else y[idx]
    nr = In.sum(axis=0)
    valid = (nr > 0) & (nr < m)
    if not valid.any():
        return None
    sr = yn @ In
    ssr = (yn * yn) @ In
    nl = m - nr
    sl = s - sr
    with np.errstate(invalid="ignore", divide="ignore"):
        sse_l = (ss - ssr) - sl * sl / nl
        sse_r = ssr - sr * sr / nr
        gains = parent_sse - sse_l - sse_r
    gains[~valid] = -np.inf
    i = int(np.argmax(gains))
    return (float(gains[i]), int(ps.bin_cols[i]), float(ps.bin_thr[i]))


def _best_split_reg_sorted(ps: Presort, y: np.ndarray, no: np.ndarray,
                           parent_sse: float, s: float,
                           ss: float) -> tuple[float, int, float] | None:
    d, m = no.shape
    if d == 0 or m < 2:
        return None
    best: tuple[float, int, float] | None = None
    block = max(1, _FEATURE_BLOCK // m)
    for lo in range(0, d, block):
        o = no[lo:lo + block]
        RV = np.take_along_axis(ps.ranks_nb[lo:lo + block], o, axis=1)
        boundary = RV[:, :-1] != RV[:, 1:]
        ridx = np.flatnonzero(boundary.any(axis=1))
        if ridx.size == 0:
            continue
        ov = o[ridx]
        rows, cols = np.nonzero(boundary[ridx])
        Y = y[ov]
        ls = np.cumsum(Y, axis=1)[rows, cols]
        lss = np.cumsum(Y * Y, axis=1)[rows, cols]
        cl = (cols + 1).astype(np.float64)
        sse_l = lss - ls * ls / cl
        sse_r = (ss - lss) - (s - ls) ** 2 / (m - cl)
        gains = parent_sse - sse_l - sse_r
        i = int(np.argmax(gains))
        g = float(gains[i])
        if best is None or g > best[0]:
            fa = lo + int(ridx[rows[i]])     # chunk-local -> nb-global
            pos = int(cols[i])
            a = ps.XT[ps.nb_cols[fa], ov[rows[i], pos]]
            b = ps.XT[ps.nb_cols[fa], ov[rows[i], pos + 1]]
            best = (g, int(ps.nb_cols[fa]), float((a + b) / 2.0))
    return best


# -- shared growth machinery -------------------------------------------------

def _partition_sorted(parent_no: np.ndarray, left_idx: np.ndarray,
                      n: int) -> tuple[np.ndarray, np.ndarray]:
    """Split a node's presorted row matrix between its children.

    A stable boolean filter of each presorted row preserves the sort,
    so children never pay another argsort.
    """
    mask = np.zeros(n, dtype=bool)
    mask[left_idx] = True
    sel = mask[parent_no]
    d = parent_no.shape[0]
    return (parent_no[sel].reshape(d, -1),
            parent_no[~sel].reshape(d, -1))


def _flatten(root, leaf_value) -> tuple[np.ndarray, ...]:
    """Preorder array form of a tree for vectorized batch descent.

    Leaves self-loop (``left == right == own slot``), so descent can
    run a fixed number of rounds without an activity mask.
    """
    nodes: list = []

    def walk(nd) -> None:
        nodes.append(nd)
        if nd.feature is not None:
            walk(nd.left)
            walk(nd.right)

    walk(root)
    slot = {id(nd): i for i, nd in enumerate(nodes)}
    size = len(nodes)
    feat = np.full(size, -1, dtype=np.int64)
    thr = np.zeros(size, dtype=np.float64)
    left = np.arange(size, dtype=np.int64)
    right = np.arange(size, dtype=np.int64)
    val = np.zeros(size, dtype=np.float64)
    for i, nd in enumerate(nodes):
        if nd.feature is not None:
            feat[i] = nd.feature
            thr[i] = nd.threshold
            left[i] = slot[id(nd.left)]
            right[i] = slot[id(nd.right)]
        else:
            val[i] = leaf_value(nd)
    return feat, thr, left, right, val


def _descend(flat: tuple[np.ndarray, ...], X: np.ndarray) -> np.ndarray:
    """Leaf slot per row of ``X`` (vectorized batch traversal)."""
    feat, thr, left, right, _ = flat
    cur = np.zeros(len(X), dtype=np.int64)
    rows = np.arange(len(X))
    while True:
        f = feat[cur]
        active = f >= 0
        if not active.any():
            return cur
        xv = X[rows, np.where(active, f, 0)]
        nxt = np.where(xv <= thr[cur], left[cur], right[cur])
        cur = np.where(active, nxt, cur)


def forest_leaf_values(trees, X: np.ndarray) -> np.ndarray:
    """Per-tree leaf predictions for a whole ensemble in one descent.

    ``trees`` is a sequence of fitted :class:`RegressionTree` /
    :class:`DecisionTree`; the result is ``(n_trees, n_rows)`` with
    row ``t`` equal to ``trees[t]``'s raw leaf values on ``X`` (the
    regression mean per leaf; the *encoded* majority class for
    classifiers). All trees' flattened node arrays are concatenated
    with slot offsets and descended together — one gather per level of
    the deepest tree instead of one full descent per tree, which is
    what makes per-tree ensemble variance
    (:meth:`repro_torch.rules.boost.GradientBoostedSurrogate.
    predict_with_std`) cheap enough to sit in the acquisition hot
    path. Leaves self-loop, so rows that finish early idle at their
    leaf slot without a compaction pass.
    """
    if not trees:
        raise ValueError("forest_leaf_values needs at least one tree")
    X = np.asarray(X, dtype=np.float64)
    flats = [t._flatten() for t in trees]
    sizes = np.array([f[0].size for f in flats], dtype=np.int64)
    off = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    feat = np.concatenate([f[0] for f in flats])
    thr = np.concatenate([f[1] for f in flats])
    left = np.concatenate([f[2] + o for f, o in zip(flats, off)])
    right = np.concatenate([f[3] + o for f, o in zip(flats, off)])
    val = np.concatenate([f[4] for f in flats])
    n_trees, n = len(flats), len(X)
    cur = np.repeat(off, n)                       # each tree's root slot
    rows = np.tile(np.arange(n), n_trees)
    while True:
        f = feat[cur]
        active = f >= 0
        if not active.any():
            break
        xv = X[rows, np.where(active, f, 0)]
        nxt = np.where(xv <= thr[cur], left[cur], right[cur])
        cur = np.where(active, nxt, cur)
    return val[cur].reshape(n_trees, n)


class DecisionTree:
    """CART classifier (gini, balanced class weights, best-first growth).

    ``splitter="vectorized"`` (default) and ``splitter="loop"`` grow
    bit-identical trees; the former scores all candidate splits with
    numpy/BLAS array ops over a :class:`Presort` analysis. Pass a
    shared ``presort`` to ``fit`` to amortize that analysis across
    fits on the same feature matrix.
    """

    _SPLITTERS = ("vectorized", "loop")

    def __init__(self, max_leaf_nodes: int, max_depth: int | None = None,
                 splitter: str = "vectorized"):
        if max_leaf_nodes < 2:
            raise ValueError("max_leaf_nodes must be >= 2")
        if splitter not in self._SPLITTERS:
            raise ValueError(f"splitter must be one of {self._SPLITTERS}")
        self.max_leaf_nodes = max_leaf_nodes
        self.max_depth = max_depth
        self.splitter = splitter
        self.root: TreeNode | None = None
        self.n_classes = 0
        self.classes_: np.ndarray | None = None
        self._flat: tuple[np.ndarray, ...] | None = None

    # -- fitting ----------------------------------------------------------
    def fit(self, X: np.ndarray, y: np.ndarray,
            presort: Presort | None = None,
            split_cache: dict | None = None) -> "DecisionTree":
        """Fit on (X, y); see the class docstring.

        ``split_cache`` memoizes best-split candidates by node row-set
        across fits on the **same (X, y)** — a node's best split does
        not depend on ``max_leaf_nodes``/``max_depth``, so the
        Algorithm-1 sweep passes one dict and every re-trial reuses the
        shallow splits it already scored. Never share a cache across
        different data.
        """
        ps = _check_presort(presort, X)
        y = np.asarray(y)
        if len(y) != ps.n:
            raise ValueError(f"X has {ps.n} rows but y has {len(y)}")
        self.classes_, y_enc = np.unique(y, return_inverse=True)
        y_enc = y_enc.astype(np.int32)       # halves per-node gathers
        self.n_classes = K = len(self.classes_)
        n = ps.n
        # class_weight='balanced': w_c = n / (k * n_c)
        counts = np.bincount(y_enc, minlength=K)
        class_w = np.where(counts > 0,
                           n / (K * np.maximum(counts, 1)), 0.0)
        vectorized = self.splitter == "vectorized"
        track_sorted = vectorized and ps.nb_cols.size > 0

        ids = itertools.count()
        all_idx = np.arange(n)
        self.root = TreeNode(next(ids), 0, all_idx,
                             class_w * counts, n_samples=n)
        sorted_rows: dict[int, np.ndarray] = {}
        if track_sorted:
            sorted_rows[self.root.node_id] = ps.order_nb

        def best_split(node: TreeNode) -> _Candidate | None:
            idx = node.indices
            if len(idx) < 2:
                return None
            key = idx.tobytes() if split_cache is not None else None
            if key is not None and key in split_cache:
                return split_cache[key]
            parent_imp = _gini(node.value)
            if parent_imp == 0.0:
                return None
            tot_w = _wsum(node.value)
            if vectorized:
                tcnt = np.bincount(y_enc[idx], minlength=K)
                res = None
                if ps.bin_cols.size:
                    res = _best_split_binary(ps, y_enc, class_w, idx,
                                             tcnt, parent_imp, tot_w)
                if track_sorted:
                    res = _merge_candidates(res, _best_split_sorted(
                        ps, y_enc, class_w, sorted_rows[node.node_id],
                        tcnt, parent_imp, tot_w))
            else:
                res = _best_split_loop(ps, y_enc, class_w, idx,
                                       parent_imp, tot_w)
            # Zero-gain splits are allowed (CART/sklearn semantics):
            # XOR-style labels need a gainless first split to become
            # separable; max_leaf_nodes bounds growth.
            cand = None
            if res is not None and res[0] >= -1e-12:
                gain, f, thr = res
                went = ps.X[idx, f] <= thr
                li, ri = idx[went], idx[~went]
                lv = class_w * np.bincount(y_enc[li], minlength=K)
                rv = class_w * np.bincount(y_enc[ri], minlength=K)
                cand = _Candidate(gain, f, thr, li, ri, lv, rv)
            if key is not None:
                split_cache[key] = cand
            return cand

        # Best-first growth: split the frontier leaf with the largest
        # impurity-decrease until max_leaf_nodes is reached.
        heap: list[tuple[float, int, TreeNode, _Candidate]] = []

        def push(node: TreeNode) -> None:
            if self.max_depth is not None and node.depth >= self.max_depth:
                sorted_rows.pop(node.node_id, None)
                return
            cand = best_split(node)
            if cand is None:
                sorted_rows.pop(node.node_id, None)
                return
            heapq.heappush(heap, (-cand.gain, node.node_id, node, cand))

        push(self.root)
        n_leaves = 1
        while heap and n_leaves < self.max_leaf_nodes:
            _, _, node, cand = heapq.heappop(heap)
            node.feature = cand.feature
            node.threshold = cand.threshold
            node.left = TreeNode(next(ids), node.depth + 1, cand.left_idx,
                                 cand.left_value, len(cand.left_idx))
            node.right = TreeNode(next(ids), node.depth + 1, cand.right_idx,
                                  cand.right_value, len(cand.right_idx))
            n_leaves += 1
            if track_sorted:
                lno, rno = _partition_sorted(
                    sorted_rows.pop(node.node_id), cand.left_idx, n)
                sorted_rows[node.left.node_id] = lno
                sorted_rows[node.right.node_id] = rno
            push(node.left)
            push(node.right)
        sorted_rows.clear()
        self._flat = None
        return self

    # -- inference ----------------------------------------------------------
    def _leaf(self, x: np.ndarray) -> TreeNode:
        node = self.root
        assert node is not None, "tree not fitted"
        while not node.is_leaf:
            node = node.left if x[node.feature] <= node.threshold \
                else node.right
        return node

    def _flatten(self) -> tuple[np.ndarray, ...]:
        if self._flat is None:
            assert self.root is not None, "tree not fitted"
            self._flat = _flatten(self.root,
                                  lambda nd: float(nd.majority_class()))
        return self._flat

    def predict(self, X: np.ndarray) -> np.ndarray:
        """Class label per row — one vectorized descent for the batch."""
        X = np.asarray(X, dtype=np.float64)
        flat = self._flatten()
        slots = _descend(flat, X)
        return self.classes_[flat[4][slots].astype(np.int64)]

    def training_error(self, X: np.ndarray, y: np.ndarray) -> float:
        return float(np.mean(self.predict(X) != np.asarray(y)))

    # -- structure ----------------------------------------------------------
    def leaves(self) -> list[TreeNode]:
        out: list[TreeNode] = []

        def walk(node: TreeNode) -> None:
            if node.is_leaf:
                out.append(node)
            else:
                walk(node.left)
                walk(node.right)

        if self.root is not None:
            walk(self.root)
        return out

    def depth(self) -> int:
        def d(node: TreeNode) -> int:
            if node.is_leaf:
                return node.depth
            return max(d(node.left), d(node.right))
        return d(self.root) if self.root is not None else 0

    def n_leaves(self) -> int:
        return len(self.leaves())

    def paths(self) -> list[tuple[list[tuple[int, float, bool]], TreeNode]]:
        """All (path, leaf) pairs; path = [(feature, threshold, went_right)]."""
        out = []

        def walk(node: TreeNode, path):
            if node.is_leaf:
                out.append((list(path), node))
                return
            walk(node.left, path + [(node.feature, node.threshold, False)])
            walk(node.right, path + [(node.feature, node.threshold, True)])

        if self.root is not None:
            walk(self.root, [])
        return out


# -- regression trees (boosting base learner) --------------------------------

@dataclasses.dataclass
class RegressionNode:
    node_id: int
    depth: int
    indices: np.ndarray
    mean: float
    sse: float
    n_samples: int
    feature: int | None = None
    threshold: float = 0.5
    left: "RegressionNode | None" = None
    right: "RegressionNode | None" = None

    @property
    def is_leaf(self) -> bool:
        return self.feature is None


@dataclasses.dataclass
class _RegCandidate:
    gain: float
    feature: int
    threshold: float
    left_idx: np.ndarray
    right_idx: np.ndarray


class RegressionTree:
    """Least-squares CART on the same vectorized split kernels.

    Best-first growth by SSE reduction under ``max_leaf_nodes`` /
    ``max_depth``; leaf prediction is the mean target. The base
    learner of :class:`repro_torch.rules.boost.GradientBoostedSurrogate` —
    every boosting round refits on new residuals but shares one
    :class:`Presort` (the feature matrix never changes).
    """

    def __init__(self, max_leaf_nodes: int = 8,
                 max_depth: int | None = None, min_gain: float = 1e-12):
        if max_leaf_nodes < 2:
            raise ValueError("max_leaf_nodes must be >= 2")
        self.max_leaf_nodes = max_leaf_nodes
        self.max_depth = max_depth
        self.min_gain = min_gain
        self.root: RegressionNode | None = None
        self._flat: tuple[np.ndarray, ...] | None = None

    def fit(self, X: np.ndarray, y: np.ndarray,
            presort: Presort | None = None) -> "RegressionTree":
        ps = _check_presort(presort, X)
        y = np.asarray(y, dtype=np.float64)
        if len(y) != ps.n:
            raise ValueError(f"X has {ps.n} rows but y has {len(y)}")
        n = ps.n
        track_sorted = ps.nb_cols.size > 0

        def stats(idx: np.ndarray) -> tuple[float, float, float]:
            yi = y[idx]
            s = float(yi.sum())
            ss = float((yi * yi).sum())
            return s, ss, max(0.0, ss - s * s / max(1, len(idx)))

        ids = itertools.count()
        all_idx = np.arange(n)
        s0, ss0, sse0 = stats(all_idx)
        self.root = RegressionNode(next(ids), 0, all_idx,
                                   s0 / max(1, n), sse0, n)
        sorted_rows: dict[int, np.ndarray] = {}
        if track_sorted:
            sorted_rows[self.root.node_id] = ps.order_nb

        def best_split(node: RegressionNode) -> _RegCandidate | None:
            idx = node.indices
            if len(idx) < 2 or node.sse <= self.min_gain:
                return None
            s, ss, sse = stats(idx)
            res = None
            if ps.bin_cols.size:
                res = _best_split_reg_binary(ps, y, idx, sse, s, ss)
            if track_sorted:
                res = _merge_candidates(res, _best_split_reg_sorted(
                    ps, y, sorted_rows[node.node_id], sse, s, ss))
            if res is None or res[0] <= self.min_gain:
                return None
            gain, f, thr = res
            went = ps.X[idx, f] <= thr
            return _RegCandidate(gain, f, thr, idx[went], idx[~went])

        heap: list[tuple[float, int, RegressionNode, _RegCandidate]] = []

        def push(node: RegressionNode) -> None:
            if self.max_depth is not None and node.depth >= self.max_depth:
                sorted_rows.pop(node.node_id, None)
                return
            cand = best_split(node)
            if cand is None:
                sorted_rows.pop(node.node_id, None)
                return
            heapq.heappush(heap, (-cand.gain, node.node_id, node, cand))

        push(self.root)
        n_leaves = 1
        while heap and n_leaves < self.max_leaf_nodes:
            _, _, node, cand = heapq.heappop(heap)
            node.feature = cand.feature
            node.threshold = cand.threshold
            for attr, ci in (("left", cand.left_idx),
                             ("right", cand.right_idx)):
                s, ss, sse = stats(ci)
                setattr(node, attr,
                        RegressionNode(next(ids), node.depth + 1, ci,
                                       s / len(ci), sse, len(ci)))
            n_leaves += 1
            if track_sorted:
                lno, rno = _partition_sorted(
                    sorted_rows.pop(node.node_id), cand.left_idx, n)
                sorted_rows[node.left.node_id] = lno
                sorted_rows[node.right.node_id] = rno
            push(node.left)
            push(node.right)
        sorted_rows.clear()
        self._flat = None
        return self

    def _flatten(self) -> tuple[np.ndarray, ...]:
        if self._flat is None:
            assert self.root is not None, "tree not fitted"
            self._flat = _flatten(self.root, lambda nd: nd.mean)
        return self._flat

    def predict(self, X: np.ndarray) -> np.ndarray:
        X = np.asarray(X, dtype=np.float64)
        flat = self._flatten()
        return flat[4][_descend(flat, X)]

    def n_leaves(self) -> int:
        def count(nd: RegressionNode) -> int:
            if nd.is_leaf:
                return 1
            return count(nd.left) + count(nd.right)
        return count(self.root) if self.root is not None else 0

    def depth(self) -> int:
        def d(nd: RegressionNode) -> int:
            if nd.is_leaf:
                return nd.depth
            return max(d(nd.left), d(nd.right))
        return d(self.root) if self.root is not None else 0


# -- the paper's Algorithm 1 -------------------------------------------------

@dataclasses.dataclass
class TreeSearchTrace:
    max_leaf_nodes: list[float]
    errors: list[float]
    depths: list[int]


def algorithm1(X: np.ndarray, y: np.ndarray,
               initial_leaves: int | None = None,
               trace: TreeSearchTrace | None = None,
               presort: Presort | None = None,
               splitter: str = "vectorized") -> DecisionTree:
    """Paper Algorithm 1: grow max_leaf_nodes until error stops shrinking.

    ``train(mln)`` fits a tree with max_leaf_nodes=mln and
    max_depth=mln-1. Starting leaf count = number of classes (the paper's
    listing initialises with 2; we use max(2, n_classes) per §IV-C text).

    Warm start: the per-feature sort/arity analysis (:class:`Presort`)
    is computed once and reused by every trial of the sweep — the
    feature matrix is the same; only ``max_leaf_nodes`` moves — and
    the trials share a split cache, so a re-trial only scores the
    frontier nodes its predecessors never reached. Pass ``presort`` to
    share the analysis even further (e.g. with a boosted surrogate on
    the same matrix).
    """
    ps = _check_presort(presort, X)
    n_classes = len(np.unique(y))
    mln = initial_leaves if initial_leaves is not None \
        else max(2, n_classes)
    split_cache: dict = {}

    def train(k: int) -> tuple[float, DecisionTree]:
        t = DecisionTree(max_leaf_nodes=k, max_depth=k - 1,
                         splitter=splitter).fit(ps.X, y, presort=ps,
                                                split_cache=split_cache)
        e = t.training_error(ps.X, y)
        if trace is not None:
            trace.max_leaf_nodes.append(k)
            trace.errors.append(e)
            trace.depths.append(t.depth())
        return e, t

    err, clf = train(mln)
    improved = True
    while improved and err > 0.0:
        improved = False
        for i in range(1, 6):
            cur, nclf = train(mln + i)
            if cur < err:
                err, clf, mln = cur, nclf, mln + i
                improved = True
                break
    return clf


# -- out-of-core histogram training (blockwise CART) -------------------------

class ClassCountHistogram:
    """Exact per-feature x per-class integer count histogram.

    The foldable sufficient statistic of a CART node: for every
    feature, how many rows of each class sit at each of the feature's
    finitely many values. Binary features are 0/1 indicators and
    multi-valued features have finite arity, so the counts are exact
    ``int64`` integers — no sketching, no approximation — which is what
    lets the histogram-trained tree reproduce the in-memory splitter
    bit for bit.

    ``values[j]`` is feature ``j``'s strictly increasing value grid;
    all features' bins live concatenated in one ``(total_bins,
    n_classes)`` count matrix (``offsets[j]:offsets[j+1]`` is feature
    ``j``'s segment), so ``add`` folds a whole block with a single
    ``np.bincount`` and ``subtract``/``merge`` are plain array
    arithmetic. ``merge`` is associative and commutative (grids union,
    counts add), so histograms folded on sharded hosts combine in any
    order — mirroring the engine's sharded-miss design.
    """

    def __init__(self, values: list[np.ndarray], n_classes: int):
        if n_classes < 1:
            raise ValueError("n_classes must be >= 1")
        self.values = [np.ascontiguousarray(np.asarray(v, dtype=np.float64)
                                            .ravel()) for v in values]
        for j, v in enumerate(self.values):
            if v.size == 0:
                raise ValueError(f"feature {j} has an empty value grid")
            if v.size > 1 and not np.all(v[1:] > v[:-1]):
                raise ValueError(
                    f"feature {j} grid must be strictly increasing")
        sizes = np.array([v.size for v in self.values], dtype=np.int64)
        self.offsets = np.zeros(sizes.size + 1, dtype=np.int64)
        np.cumsum(sizes, out=self.offsets[1:])
        self.n_classes = int(n_classes)
        self.counts = np.zeros((int(self.offsets[-1]), self.n_classes),
                               dtype=np.int64)
        # Arity-2 features bin with one vectorized comparison against
        # the upper grid value; everything else takes a per-feature
        # searchsorted.
        self._bin2 = np.flatnonzero(sizes == 2)
        self._multi = np.flatnonzero(sizes != 2)
        if self._bin2.size:
            self._lo2 = np.array([self.values[j][0] for j in self._bin2])
            self._hi2 = np.array([self.values[j][1] for j in self._bin2])
        else:
            self._lo2 = self._hi2 = np.zeros(0, dtype=np.float64)

    @property
    def n_features(self) -> int:
        return len(self.values)

    def add(self, X: np.ndarray, y_enc: np.ndarray) -> "ClassCountHistogram":
        """Fold one ``(rows, n_features)`` block of encoded labels."""
        X = np.asarray(X)
        if X.ndim != 2 or X.shape[1] != self.n_features:
            raise ValueError(
                f"expected (rows, {self.n_features}) block, got {X.shape}")
        m = X.shape[0]
        if m == 0:
            return self
        y_enc = np.asarray(y_enc)
        if y_enc.shape != (m,):
            raise ValueError(
                f"block has {m} rows but y_enc has shape {y_enc.shape}")
        K = self.n_classes
        bins = np.empty((m, self.n_features), dtype=np.int64)
        if self._bin2.size:
            Xb = np.asarray(X[:, self._bin2], dtype=np.float64)
            is_hi = Xb == self._hi2[None, :]
            if not (is_hi | (Xb == self._lo2[None, :])).all():
                raise ValueError("value outside a binary feature's grid")
            bins[:, self._bin2] = is_hi
        for j in self._multi:
            v = self.values[j]
            col = np.asarray(X[:, j], dtype=np.float64)
            b = np.minimum(np.searchsorted(v, col), v.size - 1)
            if not np.array_equal(v[b], col):
                raise ValueError(
                    f"value outside feature {int(j)}'s grid")
            bins[:, j] = b
        flat = (bins + self.offsets[:-1][None, :]) * K + y_enc[:, None]
        self.counts += np.bincount(
            flat.ravel(), minlength=self.counts.size
        ).reshape(self.counts.shape)
        return self

    def class_counts(self) -> np.ndarray:
        """Node class totals (feature 0's bins; every feature agrees)."""
        return self.counts[self.offsets[0]:self.offsets[1]].sum(axis=0)

    @property
    def n(self) -> int:
        return int(self.class_counts().sum())

    def _check_shape(self, other: "ClassCountHistogram") -> None:
        if not isinstance(other, ClassCountHistogram):
            raise TypeError(f"expected ClassCountHistogram, got "
                            f"{type(other).__name__}")
        if other.n_classes != self.n_classes:
            raise ValueError("class counts disagree on n_classes")
        if other.n_features != self.n_features:
            raise ValueError("class counts disagree on n_features")

    def _same_grids(self, other: "ClassCountHistogram") -> bool:
        return all(np.array_equal(a, b)
                   for a, b in zip(self.values, other.values))

    def subtract(self, other: "ClassCountHistogram") -> "ClassCountHistogram":
        """``self - other`` on identical grids — the sibling trick
        ``right_child = parent - left_child`` that halves per-level
        scan work during growth. Returns a new histogram."""
        self._check_shape(other)
        if not self._same_grids(other):
            raise ValueError("subtract requires identical value grids")
        out = ClassCountHistogram(self.values, self.n_classes)
        np.subtract(self.counts, other.counts, out=out.counts)
        if np.any(out.counts < 0):
            raise ValueError("subtrahend is not a sub-histogram")
        return out

    def merge(self, other: "ClassCountHistogram") -> "ClassCountHistogram":
        """Exact union of two disjoint corpora's histograms.

        Grids union (``np.union1d`` is exact on floats), counts land at
        their value's position in the union — associative, commutative,
        and equal to single-stream ``add`` of both corpora. Returns a
        new histogram; neither input is touched.
        """
        self._check_shape(other)
        if self._same_grids(other):
            out = ClassCountHistogram(self.values, self.n_classes)
            np.add(self.counts, other.counts, out=out.counts)
            return out
        grids = [np.union1d(a, b)
                 for a, b in zip(self.values, other.values)]
        out = ClassCountHistogram(grids, self.n_classes)
        for src in (self, other):
            for j in range(self.n_features):
                pos = out.offsets[j] + np.searchsorted(out.values[j],
                                                       src.values[j])
                out.counts[pos] += src.counts[src.offsets[j]:
                                              src.offsets[j + 1]]
        return out


def _hist_best_split(hist: ClassCountHistogram, bin_f: np.ndarray,
                     nb_f: np.ndarray, class_w: np.ndarray,
                     tcnt: np.ndarray, m: int, parent_imp: float,
                     tot_w: float) -> tuple[float, int, float] | None:
    """Best ``(gain, feature, threshold)`` of a node from its histogram.

    Bit-identical to the in-memory vectorized splitter on an equal
    node: the arity-2 candidates reproduce ``_best_split_binary``'s
    count math (right histogram = upper-value bin counts) and
    first-argmax tie-break over ascending feature index; multi-valued
    candidates reproduce ``_best_split_sorted``'s boundary enumeration
    — thresholds between consecutive *present* grid values, left
    counts as cumulative per-bin class sums — with its strictly-greater
    cross-feature merge; and the two paths resolve ties through the
    same :func:`_merge_candidates`.
    """
    K = len(class_w)
    best: tuple[float, int, float] | None = None
    if bin_f.size:
        rcnt = hist.counts[hist.offsets[bin_f] + 1]      # upper-value bin
        nright = rcnt.sum(axis=1)
        valid = (nright > 0) & (nright < m)
        if valid.any():
            left_counts = [tcnt[k] - rcnt[:, k] for k in range(K)]
            right_counts = [rcnt[:, k] for k in range(K)]
            with np.errstate(invalid="ignore", divide="ignore"):
                gains = _gini_gains(left_counts, right_counts, class_w,
                                    parent_imp, tot_w)
            gains[~valid] = -np.inf
            i = int(np.argmax(gains))        # first max: lowest feature
            v = hist.values[int(bin_f[i])]
            best = (float(gains[i]), int(bin_f[i]),
                    float((v[0] + v[1]) / 2.0))
    snd: tuple[float, int, float] | None = None
    for f in nb_f:
        seg = hist.counts[hist.offsets[f]:hist.offsets[f + 1]]
        pres = np.flatnonzero(seg.sum(axis=1) > 0)
        if pres.size < 2:
            continue
        lc = np.cumsum(seg[pres[:-1]], axis=0)    # left of boundary i
        left_counts = [lc[:, k] for k in range(K)]
        right_counts = [tcnt[k] - lc[:, k] for k in range(K)]
        gains = _gini_gains(left_counts, right_counts, class_w,
                            parent_imp, tot_w)
        i = int(np.argmax(gains))
        g = float(gains[i])
        if snd is None or g > snd[0]:    # strict: earlier feature wins
            v = hist.values[int(f)][pres]
            snd = (g, int(f), float((v[i] + v[i + 1]) / 2.0))
    return _merge_candidates(best, snd)


class _HistNode:
    """Node of the level-order histogram expansion (grower internal)."""

    __slots__ = ("depth", "counts", "n_samples", "hist", "cand",
                 "cand_done", "feature", "threshold", "left", "right")

    def __init__(self, depth: int, counts: np.ndarray | None = None,
                 n_samples: int = 0,
                 hist: ClassCountHistogram | None = None):
        self.depth = depth
        self.counts = counts
        self.n_samples = n_samples
        self.hist = hist
        self.cand: tuple[float, int, float] | None = None
        self.cand_done = False
        self.feature: int | None = None
        self.threshold = 0.5
        self.left: "_HistNode | None" = None
        self.right: "_HistNode | None" = None


class HistogramGrower:
    """Out-of-core CART growth: one blockwise pass per tree level.

    ``blocks`` is a callable returning an iterable of ``(rows,
    n_features)`` blocks (or a re-iterable sequence of such blocks) —
    typically a :class:`repro_torch.driver.sinks.HistogramSink` featurizing
    stored compact encodings on the fly. The grower never materializes
    the ``(rows x features)`` matrix: it holds one
    :class:`ClassCountHistogram` per *frontier* node (O(features x
    bins x frontier) memory) and expands the candidate tree level by
    level — each level is a single pass over the blocks, routing rows
    with the vectorized :func:`_descend` and folding only the
    **left**-child histograms; right children come free from the
    subtraction trick ``right = parent - left``.

    :meth:`fit` then replays the in-memory best-first heap over the
    pre-expanded candidates, producing a genuine :class:`DecisionTree`
    that is bit-identical (splits, thresholds, tie-breaks, ``predict``)
    to ``DecisionTree(...).fit(X, y)`` on the materialized matrix —
    locked by tests/test_torch_trees.py. A node popped at depth
    ``D`` needs ``D + 1`` of the at most ``max_leaf_nodes - 1`` pops,
    so candidates are only ever needed down to depth
    ``min(max_leaf_nodes - 2, max_depth - 1)``; repeated ``fit`` calls
    (the Algorithm-1 sweep) reuse every level already expanded, the
    histogram path's analogue of the in-memory ``split_cache``.
    """

    def __init__(self, blocks, y: np.ndarray,
                 values: list[np.ndarray] | None = None):
        self._blocks = blocks if callable(blocks) else (lambda: blocks)
        self.y = np.asarray(y)
        if self.y.ndim != 1:
            raise ValueError(f"y must be 1-D, got shape {self.y.shape}")
        self.n = int(self.y.shape[0])
        if self.n == 0:
            raise ValueError("y is empty")
        self.classes_, y_enc = np.unique(self.y, return_inverse=True)
        self.y_enc = y_enc.astype(np.int32)
        self.n_classes = K = len(self.classes_)
        counts = np.bincount(self.y_enc, minlength=K)
        # class_weight='balanced', exactly as DecisionTree.fit
        self.class_w = np.where(counts > 0,
                                self.n / (K * np.maximum(counts, 1)), 0.0)
        if values is None:
            values = self._discover_values()
        self.values = [np.asarray(v, dtype=np.float64) for v in values]
        self.n_features = len(self.values)
        arity = np.array([v.size for v in self.values], dtype=np.int64)
        self.bin_f = np.flatnonzero(arity == 2)
        self.nb_f = np.flatnonzero(arity >= 3)
        root_hist = ClassCountHistogram(self.values, K)
        rows = 0
        for X, lo in self._iter():
            root_hist.add(X, self.y_enc[lo:lo + X.shape[0]])
            rows += X.shape[0]
        if rows != self.n:
            raise ValueError(
                f"blocks yielded {rows} rows but y has {self.n}")
        self.root = _HistNode(0, counts.astype(np.int64), self.n,
                              root_hist)
        self._frontier: list[_HistNode] = [self.root]
        self._cand_depth = -1          # deepest level with candidates
        self._exhausted = False

    def _iter(self):
        lo = 0
        for X in self._blocks():
            X = np.asarray(X)
            if X.ndim != 2:
                raise ValueError(f"blocks must be 2-D, got {X.shape}")
            if lo + X.shape[0] > self.n:
                raise ValueError(
                    f"blocks yielded more than {self.n} rows")
            yield X, lo
            lo += X.shape[0]

    def _discover_values(self) -> list[np.ndarray]:
        vals: list[np.ndarray] | None = None
        for X, _ in self._iter():
            cols = [np.unique(np.asarray(X[:, j], dtype=np.float64))
                    for j in range(X.shape[1])]
            if vals is None:
                vals = cols
            elif len(cols) != len(vals):
                raise ValueError("blocks disagree on feature count")
            else:
                vals = [np.union1d(a, b) for a, b in zip(vals, cols)]
        if vals is None:
            raise ValueError("blocks yielded no rows")
        return vals

    # -- level-order expansion -------------------------------------------
    def _candidate(self, nd: _HistNode) -> tuple[float, int, float] | None:
        if nd.n_samples < 2:
            return None
        parent_imp = _gini(self.class_w * nd.counts)
        if parent_imp == 0.0:
            return None
        tot_w = _wsum(self.class_w * nd.counts)
        res = _hist_best_split(nd.hist, self.bin_f, self.nb_f,
                               self.class_w, nd.counts, nd.n_samples,
                               parent_imp, tot_w)
        # Zero-gain splits are allowed (CART/sklearn semantics), same
        # tolerance as the in-memory grower.
        if res is not None and res[0] >= -1e-12:
            return res
        return None

    def _flatten_partial(self) -> tuple[tuple[np.ndarray, ...], dict]:
        """Flatten the expansion tree so far; unexpanded nodes self-loop."""
        nodes: list[_HistNode] = []

        def walk(nd: _HistNode) -> None:
            nodes.append(nd)
            if nd.left is not None:
                walk(nd.left)
                walk(nd.right)

        walk(self.root)
        slot = {id(nd): i for i, nd in enumerate(nodes)}
        size = len(nodes)
        feat = np.full(size, -1, dtype=np.int64)
        thr = np.zeros(size, dtype=np.float64)
        left = np.arange(size, dtype=np.int64)
        right = np.arange(size, dtype=np.int64)
        for i, nd in enumerate(nodes):
            if nd.left is not None:
                feat[i] = nd.feature
                thr[i] = nd.threshold
                left[i] = slot[id(nd.left)]
                right[i] = slot[id(nd.right)]
        return (feat, thr, left, right, np.zeros(size)), slot

    def _expand_level(self) -> None:
        level = self._frontier
        for nd in level:
            if not nd.cand_done:
                nd.cand = self._candidate(nd)
                nd.cand_done = True
        self._cand_depth += 1
        splitting = [nd for nd in level if nd.cand is not None]
        if not splitting:
            for nd in level:
                nd.hist = None
            self._frontier = []
            self._exhausted = True
            return
        K = self.n_classes
        for nd in splitting:
            _, f, thr = nd.cand
            nd.feature, nd.threshold = int(f), float(thr)
            nd.left = _HistNode(nd.depth + 1,
                                hist=ClassCountHistogram(self.values, K))
            nd.right = _HistNode(nd.depth + 1)
        flat, slot = self._flatten_partial()
        left_of = {slot[id(nd.left)]: nd for nd in splitting}
        # One routing pass over the corpus fills every new left child's
        # histogram; rows routed right (or to permanent leaves) are
        # skipped — their counts come from the subtraction trick below.
        # Routing with the *actual* split predicate (X <= thr via
        # _descend) rather than histogram-boundary arithmetic keeps the
        # partition identical to the in-memory ``ps.X[idx, f] <= thr``
        # even when a midpoint rounds onto its upper grid value.
        for X, lo in self._iter():
            where = _descend(flat, np.asarray(X, dtype=np.float64))
            yb = self.y_enc[lo:lo + X.shape[0]]
            for s, nd in left_of.items():
                mask = where == s
                if mask.any():
                    nd.left.hist.add(X[mask], yb[mask])
        for nd in splitting:
            lc = nd.left.hist.class_counts()
            nd.left.counts = lc
            nd.left.n_samples = int(lc.sum())
            nd.right.hist = nd.hist.subtract(nd.left.hist)
            nd.right.counts = nd.counts - lc
            nd.right.n_samples = nd.n_samples - nd.left.n_samples
            nd.hist = None                 # parent histogram retired
        for nd in level:
            if nd.cand is None:
                nd.hist = None             # permanent leaf
        self._frontier = [c for nd in splitting
                          for c in (nd.left, nd.right)]

    def _ensure(self, cand_depth: int) -> None:
        while self._cand_depth < cand_depth and not self._exhausted:
            self._expand_level()

    # -- producing trees --------------------------------------------------
    def fit(self, max_leaf_nodes: int,
            max_depth: int | None = None) -> DecisionTree:
        """Grow a :class:`DecisionTree` from the expanded candidates.

        Replays the in-memory best-first heap — ``(-gain, node_id)``
        ordering, pop-time child ids (left before right), depth gate
        before candidate — over the histogram-scored splits.
        """
        tree = DecisionTree(max_leaf_nodes, max_depth)
        tree.splitter = "histogram"
        tree.classes_ = self.classes_
        tree.n_classes = self.n_classes
        cand_cap = max_leaf_nodes - 2
        if max_depth is not None:
            cand_cap = min(cand_cap, max_depth - 1)
        self._ensure(cand_cap)
        ids = itertools.count()
        empty = np.zeros(0, dtype=np.int64)   # rows are never held

        def mk(hn: _HistNode) -> TreeNode:
            return TreeNode(next(ids), hn.depth, empty,
                            self.class_w * hn.counts, hn.n_samples)

        tree.root = mk(self.root)
        heap: list[tuple[float, int, TreeNode, _HistNode]] = []

        def push(tn: TreeNode, hn: _HistNode) -> None:
            if max_depth is not None and tn.depth >= max_depth:
                return
            # A node popped at depth D needs D+1 pops of the at most
            # max_leaf_nodes-1 total, so anything past cand_cap can
            # never be popped — safe to leave off the heap even though
            # the in-memory grower pushes it.
            if hn.cand is None:
                return
            heapq.heappush(heap, (-hn.cand[0], tn.node_id, tn, hn))

        push(tree.root, self.root)
        n_leaves = 1
        while heap and n_leaves < max_leaf_nodes:
            _, _, tn, hn = heapq.heappop(heap)
            tn.feature = hn.feature
            tn.threshold = hn.threshold
            tn.left = mk(hn.left)
            tn.right = mk(hn.right)
            n_leaves += 1
            push(tn.left, hn.left)
            push(tn.right, hn.right)
        tree._flat = None
        return tree

    def training_error(self, tree: DecisionTree) -> float:
        """Blockwise misclassification rate — equals
        ``tree.training_error(X, y)`` on the materialized matrix."""
        flat = tree._flatten()
        wrong = 0
        for X, lo in self._iter():
            slots = _descend(flat, np.asarray(X, dtype=np.float64))
            pred = tree.classes_[flat[4][slots].astype(np.int64)]
            wrong += int(np.count_nonzero(
                pred != self.y[lo:lo + X.shape[0]]))
        return wrong / self.n


def fit_from_histograms(blocks, y: np.ndarray, max_leaf_nodes: int,
                        max_depth: int | None = None,
                        values: list[np.ndarray] | None = None,
                        grower: HistogramGrower | None = None
                        ) -> DecisionTree:
    """One histogram-trained CART fit; see :class:`HistogramGrower`.

    ``blocks`` streams the feature matrix in row blocks (a callable
    returning an iterable, or a re-iterable sequence); ``values``
    optionally pins the per-feature value grids (skipping the
    discovery pass — sinks know their grids). Pass an existing
    ``grower`` to reuse its expanded levels across fits.
    """
    if grower is None:
        grower = HistogramGrower(blocks, y, values=values)
    return grower.fit(max_leaf_nodes, max_depth)


def algorithm1_from_histograms(blocks, y: np.ndarray,
                               initial_leaves: int | None = None,
                               trace: TreeSearchTrace | None = None,
                               values: list[np.ndarray] | None = None,
                               grower: HistogramGrower | None = None
                               ) -> DecisionTree:
    """Paper Algorithm 1 through the out-of-core histogram path.

    Identical trial schedule, stopping rule, and trees to
    :func:`algorithm1` (locked by test): the shared grower's expanded
    levels play the role of the in-memory sweep's presort +
    split cache, so each re-trial only pays passes for the levels it
    newly reaches.
    """
    if grower is None:
        grower = HistogramGrower(blocks, y, values=values)
    mln = initial_leaves if initial_leaves is not None \
        else max(2, grower.n_classes)

    def train(k: int) -> tuple[float, DecisionTree]:
        t = grower.fit(max_leaf_nodes=k, max_depth=k - 1)
        e = grower.training_error(t)
        if trace is not None:
            trace.max_leaf_nodes.append(k)
            trace.errors.append(e)
            trace.depths.append(t.depth())
        return e, t

    err, clf = train(mln)
    improved = True
    while improved and err > 0.0:
        improved = False
        for i in range(1, 6):
            cur, nclf = train(mln + i)
            if cur < err:
                err, clf, mln = cur, nclf, mln + i
                improved = True
                break
    return clf
