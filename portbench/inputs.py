"""The benchmark's inputs, made from the run's seed.

Each generator takes the seed and the sizes of the configuration, and
the same seed gives the same inputs. The program and the plain
reference are handed the same inputs; neither makes them.

:func:`band_matrix` is a frozen copy of the port's own generator
(``src/repro_torch/spmv/matrix.py:band_matrix``, the paper's circulant
band): the yardstick must not move when the program changes.
"""
from __future__ import annotations

import math

import numpy as np


def child_seed(seed: int, *path: int) -> int:
    """A 63-bit seed for one use of the run's seed (``path`` names it),
    so that two uses never share a stream."""
    ss = np.random.SeedSequence([seed % (1 << 64), *path])
    return int(ss.generate_state(1, dtype=np.uint64)[0] >> np.uint64(1))


def band_matrix(n: int, nnz: int, half_bandwidth: int,
                seed: int) -> tuple[np.ndarray, np.ndarray]:
    """(vals (n, K) float32, cols (n, K) int32): nnz entries uniform in a
    circulant band of ``half_bandwidth``, ELL layout, padded entries
    0.0 at the row's own column."""
    rng = np.random.default_rng(child_seed(seed, 1))
    per_row, rem = divmod(nnz, n)
    counts = np.full(n, per_row, dtype=np.int64)
    counts[rng.choice(n, size=rem, replace=False)] += 1
    k = int(counts.max())
    offs = rng.integers(-half_bandwidth, half_bandwidth + 1, size=(n, k),
                        dtype=np.int64)
    cols = (np.arange(n)[:, None] + offs) % n
    vals = rng.standard_normal((n, k)).astype(np.float32)
    mask = np.arange(k)[None, :] < counts[:, None]
    vals = np.where(mask, vals, 0.0).astype(np.float32)
    cols = np.where(mask, cols, np.arange(n)[:, None])
    return vals, cols.astype(np.int32)


def vectors(n: int, count: int, seed: int) -> np.ndarray:
    """(count, n) float32 standard normal vectors: the SpMV's x."""
    rng = np.random.default_rng(child_seed(seed, 2))
    return rng.standard_normal((count, n)).astype(np.float32)


def leaf_layout(shapes: dict[str, tuple[int, ...]]
                ) -> list[tuple[str, tuple[int, ...], int]]:
    """(name, shape, offset) of every leaf in one flat buffer, by name."""
    out, off = [], 0
    for name in sorted(shapes):
        out.append((name, tuple(shapes[name]), off))
        off += math.prod(shapes[name])
    return out


def draw_weights(shapes: dict[str, tuple[int, ...]],
                 scales: dict[str, float | str], seed: int, device):
    """Every leaf drawn in one call into one flat float32 buffer on
    ``device`` from a ``torch.Generator`` there: a standard normal
    times the leaf's scale, or ``"ones"``. Returns (flat buffer,
    {name: view}). The same seed and device give the same bits."""
    import torch

    layout = leaf_layout(shapes)
    total = sum(math.prod(s) for _, s, _ in layout)
    gen = torch.Generator(device=device).manual_seed(child_seed(seed, 3))
    flat = torch.empty(total, dtype=torch.float32, device=device)
    flat.normal_(0.0, 1.0, generator=gen)
    views = {}
    for name, shape, off in layout:
        v = flat[off:off + math.prod(shape)].view(shape)
        if scales[name] == "ones":
            v.fill_(1.0)
        else:
            v.mul_(float(scales[name]))
        views[name] = v
    return flat, views


class TokenStream:
    """Batches of token ids drawn on ``device`` from a generator seeded
    by the run's seed: batch i is the i-th draw, (batch, seq + 1) ids
    uniform in [0, vocab), so every row differs."""

    def __init__(self, seed: int, batch: int, seq: int, vocab: int,
                 device):
        import torch

        self.shape, self.vocab = (batch, seq + 1), vocab
        self.gen = torch.Generator(device=device).manual_seed(
            child_seed(seed, 4))
        self.device = device

    def next(self) -> dict:
        import torch

        ids = torch.randint(0, self.vocab, self.shape, generator=self.gen,
                            device=self.device)
        return {"tokens": ids[:, :-1], "labels": ids[:, 1:]}
