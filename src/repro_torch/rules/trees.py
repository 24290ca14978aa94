"""CART training for the rules subsystem (paper §IV-C, Algorithm 1).

The subset of ``DecisionTreeClassifier`` the paper uses: CART with gini
impurity, ``class_weight='balanced'``, ``max_leaf_nodes`` (best-first
growth by weighted impurity decrease, like sklearn) and ``max_depth``.

The split finder is the per-candidate loop (one masked histogram pair
per threshold). Class histograms are ``class_weight * integer_count``
and every reduction over the class axis runs in ascending class order,
so the trees are bit-identical to those of the JAX package's vectorized
splitter, which is locked to the same loop there.

The tree is intentionally allowed to overfit (paper §IV-C): it
describes the explored design space.
"""
from __future__ import annotations

import dataclasses
import heapq
import itertools

import numpy as np


def _wsum(vec) -> float:
    """Sum in ascending index order (``np.sum`` reorders by layout)."""
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


def _best_split_loop(X: np.ndarray, y_enc: np.ndarray, class_w: np.ndarray,
                     idx: np.ndarray, parent_imp: float,
                     tot_w: float) -> tuple[float, int, float] | None:
    """Split finder: one histogram pair per candidate."""
    K = len(class_w)
    Xn = X[idx]
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


class DecisionTree:
    """CART classifier (gini, balanced class weights, best-first growth)."""

    def __init__(self, max_leaf_nodes: int, max_depth: int | None = None):
        if max_leaf_nodes < 2:
            raise ValueError("max_leaf_nodes must be >= 2")
        self.max_leaf_nodes = max_leaf_nodes
        self.max_depth = max_depth
        self.root: TreeNode | None = None
        self.n_classes = 0
        self.classes_: np.ndarray | None = None

    # -- fitting ----------------------------------------------------------
    def fit(self, X: np.ndarray, y: np.ndarray,
            split_cache: dict | None = None) -> "DecisionTree":
        """Fit on (X, y).

        ``split_cache`` memoizes best-split candidates by node row-set
        across fits on the **same (X, y)** — a node's best split does
        not depend on ``max_leaf_nodes``/``max_depth``, so the
        Algorithm-1 sweep passes one dict and every re-trial reuses the
        shallow splits it already scored. Never share a cache across
        different data.
        """
        X = np.asarray(X, dtype=np.float64)
        if X.ndim != 2:
            raise ValueError(f"X must be 2-D, got shape {X.shape}")
        y = np.asarray(y)
        n = X.shape[0]
        if len(y) != n:
            raise ValueError(f"X has {n} rows but y has {len(y)}")
        self.classes_, y_enc = np.unique(y, return_inverse=True)
        y_enc = y_enc.astype(np.int32)
        self.n_classes = K = len(self.classes_)
        # class_weight='balanced': w_c = n / (k * n_c)
        counts = np.bincount(y_enc, minlength=K)
        class_w = np.where(counts > 0,
                           n / (K * np.maximum(counts, 1)), 0.0)

        ids = itertools.count()
        self.root = TreeNode(next(ids), 0, np.arange(n),
                             class_w * counts, n_samples=n)

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
            res = _best_split_loop(X, y_enc, class_w, idx, parent_imp,
                                   _wsum(node.value))
            # Zero-gain splits are allowed (CART/sklearn semantics):
            # XOR-style labels need a gainless first split to become
            # separable; max_leaf_nodes bounds growth.
            cand = None
            if res is not None and res[0] >= -1e-12:
                gain, f, thr = res
                went = X[idx, f] <= thr
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
                return
            cand = best_split(node)
            if cand is not None:
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
            push(node.left)
            push(node.right)
        return self

    # -- inference ----------------------------------------------------------
    def _leaf(self, x: np.ndarray) -> TreeNode:
        node = self.root
        if node is None:
            raise RuntimeError("tree not fitted")
        while not node.is_leaf:
            node = node.left if x[node.feature] <= node.threshold \
                else node.right
        return node

    def predict(self, X: np.ndarray) -> np.ndarray:
        """Class label per row."""
        X = np.asarray(X, dtype=np.float64)
        enc = np.array([self._leaf(x).majority_class() for x in X],
                       dtype=np.int64)
        return self.classes_[enc]

    def training_error(self, X: np.ndarray, y: np.ndarray) -> float:
        return float(np.mean(self.predict(X) != np.asarray(y)))

    # -- structure ----------------------------------------------------------
    def leaves(self) -> list[TreeNode]:
        return [leaf for _, leaf in self.paths()]

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


# -- the paper's Algorithm 1 -------------------------------------------------

@dataclasses.dataclass
class TreeSearchTrace:
    """Every trial of :func:`algorithm1`: its max_leaf_nodes, training
    error and depth."""

    max_leaf_nodes: list[float]
    errors: list[float]
    depths: list[int]


def algorithm1(X: np.ndarray, y: np.ndarray,
               trace: TreeSearchTrace | None = None) -> DecisionTree:
    """Paper Algorithm 1: grow max_leaf_nodes until error stops shrinking.

    ``train(mln)`` fits a tree with max_leaf_nodes=mln and
    max_depth=mln-1. Starting leaf count = number of classes (the paper's
    listing initialises with 2; we use max(2, n_classes) per §IV-C text);
    ``trace`` records every trial.
    The trials share a split cache, so a re-trial only scores the
    frontier nodes its predecessors never reached.
    """
    X = np.asarray(X, dtype=np.float64)
    mln = max(2, len(np.unique(y)))
    split_cache: dict = {}

    def train(k: int) -> tuple[float, DecisionTree]:
        t = DecisionTree(max_leaf_nodes=k, max_depth=k - 1).fit(
            X, y, split_cache=split_cache)
        e = t.training_error(X, y)
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
