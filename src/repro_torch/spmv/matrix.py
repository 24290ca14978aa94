"""Band-diagonal sparse matrices in ELL format (paper §III).

The paper's input: 150 000 rows/cols, 1 500 000 non-zeros uniformly
random within a band of half-width n/4 — chosen so the local and remote
multiplications are balanced when rows are block-partitioned across 4
ranks. We use a *circulant* band (wrap-around) so every rank is
symmetric, matching the cost model's symmetric-rank assumption.

ELL layout (rectangular, no row pointers):
    vals: (n, K) float32, cols: (n, K) int32
padded entries have val = 0 and col = row (a safe self-index).
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class EllMatrix:
    vals: np.ndarray  # (n, K) float32
    cols: np.ndarray  # (n, K) int32
    n_cols: int

    @property
    def n_rows(self) -> int:
        return self.vals.shape[0]

    @property
    def k(self) -> int:
        return self.vals.shape[1]

    def to_dense(self) -> np.ndarray:
        out = np.zeros((self.n_rows, self.n_cols), dtype=np.float64)
        for i in range(self.n_rows):
            np.add.at(out[i], self.cols[i], self.vals[i].astype(np.float64))
        return out

    def matvec(self, x: np.ndarray) -> np.ndarray:
        """Dense-math oracle (float64)."""
        return (self.vals.astype(np.float64) *
                x.astype(np.float64)[self.cols]).sum(axis=1)


def band_matrix(n: int = 150_000, nnz: int = 1_500_000,
                half_bandwidth: int | None = None,
                seed: int = 0) -> EllMatrix:
    """Circulant band matrix with nnz uniform in the band."""
    if half_bandwidth is None:
        half_bandwidth = n // 4
    rng = np.random.default_rng(seed)
    per_row = nnz // n
    rem = nnz - per_row * n
    counts = np.full(n, per_row, dtype=np.int64)
    counts[rng.choice(n, size=rem, replace=False)] += 1
    k = int(counts.max())

    # Offsets uniform in [-half_bandwidth, half_bandwidth], wrap mod n.
    offs = rng.integers(-half_bandwidth, half_bandwidth + 1,
                        size=(n, k), dtype=np.int64)
    cols = (np.arange(n)[:, None] + offs) % n
    vals = rng.standard_normal((n, k)).astype(np.float32)
    # Mask padding beyond each row's count.
    mask = np.arange(k)[None, :] < counts[:, None]
    vals = np.where(mask, vals, 0.0).astype(np.float32)
    cols = np.where(mask, cols, np.arange(n)[:, None] % n)
    return EllMatrix(vals=vals, cols=cols.astype(np.int32), n_cols=n)


@dataclasses.dataclass
class RankPartition:
    """Per-rank split of a band matrix into local + remote halves.

    Local columns are re-indexed into [0, m); remote columns are
    re-indexed into the rank's halo buffer = concat(left block, right
    block) of length 2m (half-bandwidth == m, so the halo is exactly the
    two neighbor blocks).
    """

    local: EllMatrix    # cols index x_local (m,)
    remote: EllMatrix   # cols index halo (2m,)
    rank: int
    n_ranks: int

    @property
    def m(self) -> int:
        return self.local.n_rows


def partition(matrix: EllMatrix, n_ranks: int) -> list[RankPartition]:
    """Block-partition rows; split each rank's nnz into local/remote."""
    n = matrix.n_rows
    assert n % n_ranks == 0, "rows must divide evenly across ranks"
    m = n // n_ranks
    parts: list[RankPartition] = []
    for r in range(n_ranks):
        rows = slice(r * m, (r + 1) * m)
        vals = matrix.vals[rows]
        cols = matrix.cols[rows]
        lo, hi = r * m, (r + 1) * m
        is_local = (cols >= lo) & (cols < hi)

        def compact(v: np.ndarray, c: np.ndarray,
                    keep: np.ndarray, width: int,
                    reindex) -> EllMatrix:
            k = max(1, int(keep.sum(axis=1).max()))
            out_v = np.zeros((m, k), dtype=np.float32)
            out_c = np.zeros((m, k), dtype=np.int32)
            for i in range(m):
                sel = keep[i]
                cnt = int(sel.sum())
                out_v[i, :cnt] = v[i, sel]
                out_c[i, :cnt] = reindex(c[i, sel])
            return EllMatrix(out_v, out_c, width)

        local = compact(vals, cols, is_local & (vals != 0), m,
                        lambda c: c - lo)

        left = (r - 1) % n_ranks
        right = (r + 1) % n_ranks

        def halo_index(c: np.ndarray) -> np.ndarray:
            # halo = [left block (m), right block (m)]
            out = np.empty_like(c)
            in_left = (c >= left * m) & (c < (left + 1) * m)
            out[in_left] = c[in_left] - left * m
            in_right = (c >= right * m) & (c < (right + 1) * m)
            out[in_right] = c[in_right] - right * m + m
            bad = ~(in_left | in_right)
            if bad.any():
                raise ValueError("column outside halo - bandwidth too wide"
                                 f" for {n_ranks} ranks")
            return out

        remote = compact(vals, cols, (~is_local) & (vals != 0), 2 * m,
                         halo_index)
        parts.append(RankPartition(local=local, remote=remote,
                                   rank=r, n_ranks=n_ranks))
    return parts


def stack_partitions(parts: list[RankPartition]) -> dict[str, np.ndarray]:
    """Stack per-rank arrays with a leading rank axis (shard_map layout).

    ELL widths are padded to the max across ranks.
    """
    kl = max(p.local.k for p in parts)
    kr = max(p.remote.k for p in parts)

    def pad(m: EllMatrix, k: int) -> tuple[np.ndarray, np.ndarray]:
        pv = np.zeros((m.n_rows, k), dtype=np.float32)
        pc = np.zeros((m.n_rows, k), dtype=np.int32)
        pv[:, :m.k] = m.vals
        pc[:, :m.k] = m.cols
        return pv, pc

    lv, lc = zip(*[pad(p.local, kl) for p in parts])
    rv, rc = zip(*[pad(p.remote, kr) for p in parts])
    return {
        "local_vals": np.stack(lv), "local_cols": np.stack(lc),
        "remote_vals": np.stack(rv), "remote_cols": np.stack(rc),
    }
