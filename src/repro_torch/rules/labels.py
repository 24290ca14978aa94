"""Performance-class labeling (paper §IV-A, Fig. 4).

1. Sort the empirical times ascending.
2. Convolve with a ±r step kernel (k = -1 on [-r, 0], +1 on (0, r)),
   r = 0.5% of the number of measurements (minimum 1), computed only where
   the kernel fully overlaps the array.
3. Detect peaks (strictly greater than neighbors), compute prominences,
   keep peaks whose prominence is above the 98th percentile of all peak
   prominences.
4. Peak locations are class boundaries; each measurement gets the class of
   its bucket (class 0 = fastest).

Peak detection/prominence are implemented from scratch (the target
container has no guaranteed scipy); tests cross-check against
``scipy.signal.find_peaks`` when scipy is importable. Prominence is
computed with numpy index/slice ops; the original per-sample Python
walk survives as :func:`peak_prominences_loop`, the reference the
vectorized version is locked to by tests/test_rules_pipeline.py.
"""
from __future__ import annotations

import dataclasses

import numpy as np


def step_convolve(sorted_times: np.ndarray, radius: int) -> np.ndarray:
    """Convolution of the sorted data with the paper's step kernel.

    The §IV-A kernel is -1 on [-r, 0] (r+1 values) and +1 on [1, r]
    (r values):

        out[i] = sum_{m=1..r} a[i+m] - sum_{m=-r..0} a[i+m]

    computed for i where both windows are in-bounds. Returned array is
    aligned with the input (non-computable entries are 0).
    """
    a = np.asarray(sorted_times, dtype=np.float64)
    n = a.size
    r = int(radius)
    out = np.zeros(n, dtype=np.float64)
    if n < 2 * r + 1:
        return out
    csum = np.concatenate([[0.0], np.cumsum(a)])

    def window(lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
        return csum[hi + 1] - csum[lo]

    idx = np.arange(r, n - r)
    right = window(idx + 1, idx + r)      # m = 1..r  (r values)
    left = window(idx - r, idx)           # m = -r..0 (r+1 values)
    out[idx] = right - left
    return out


def find_peaks(x: np.ndarray) -> np.ndarray:
    """Indices of simple local maxima (strictly greater than neighbors).

    Plateaus: the midpoint of a flat run that is higher than both sides is
    a peak (matches scipy.signal.find_peaks plateau handling).
    """
    x = np.asarray(x, dtype=np.float64)
    n = x.size
    peaks = []
    i = 1
    while i < n - 1:
        if x[i] > x[i - 1]:
            # scan plateau
            j = i
            while j < n - 1 and x[j + 1] == x[i]:
                j += 1
            if j < n - 1 and x[j + 1] < x[i]:
                peaks.append((i + j) // 2)
            i = j + 1
        else:
            i += 1
    return np.asarray(peaks, dtype=np.int64)


def peak_prominences_loop(x: np.ndarray,
                          peaks: np.ndarray) -> np.ndarray:
    """Reference prominence: per-sample Python walks (scipy's definition).

    For each peak: walk left/right until the signal exceeds the peak height
    (or the array ends); the base on each side is the minimum in that
    window; prominence = peak height - max(left base, right base).
    """
    x = np.asarray(x, dtype=np.float64)
    out = np.empty(len(peaks), dtype=np.float64)
    for k, p in enumerate(peaks):
        h = x[p]
        i = p - 1
        left_min = h
        while i >= 0 and x[i] <= h:
            left_min = min(left_min, x[i])
            i -= 1
        j = p + 1
        right_min = h
        while j < x.size and x[j] <= h:
            right_min = min(right_min, x[j])
            j += 1
        out[k] = h - max(left_min, right_min)
    return out


def peak_prominences(x: np.ndarray, peaks: np.ndarray) -> np.ndarray:
    """Prominence per scipy's definition, computed with numpy ops.

    The per-sample Python walks of :func:`peak_prominences_loop` become
    per-peak index arithmetic: the nearest strictly-higher sample on
    each side bounds the base window, and the base is a slice min.
    Locked to the loop reference by tests.
    """
    x = np.asarray(x, dtype=np.float64)
    peaks = np.asarray(peaks, dtype=np.int64)
    out = np.empty(len(peaks), dtype=np.float64)
    for k, p in enumerate(peaks):
        h = x[p]
        higher_left = np.flatnonzero(x[:p] > h)
        lb = int(higher_left[-1]) + 1 if higher_left.size else 0
        higher_right = np.flatnonzero(x[p + 1:] > h)
        rb = p + 1 + int(higher_right[0]) if higher_right.size else x.size
        left_min = x[lb:p].min() if lb < p else h
        right_min = x[p + 1:rb].min() if p + 1 < rb else h
        out[k] = h - max(left_min, right_min)
    return out


@dataclasses.dataclass
class Labeling:
    order: np.ndarray          # argsort of the input times
    sorted_times: np.ndarray
    convolution: np.ndarray
    boundaries: np.ndarray     # indices into sorted_times (class edges)
    labels: np.ndarray         # class per *input* measurement (unsorted)
    n_classes: int

    def class_ranges(self) -> list[tuple[float, float]]:
        """(t_min, t_max) per class, from the sorted data."""
        edges = [0, *list(self.boundaries + 1), self.sorted_times.size]
        out = []
        for c in range(self.n_classes):
            seg = self.sorted_times[edges[c]:edges[c + 1]]
            out.append((float(seg.min()), float(seg.max())))
        return out


def label_times(times: np.ndarray,
                radius_frac: float = 0.005,
                prominence_percentile: float = 98.0) -> Labeling:
    """Full labeling pipeline of §IV-A."""
    times = np.asarray(times, dtype=np.float64)
    order = np.argsort(times, kind="stable")
    s = times[order]
    r = max(1, int(round(radius_frac * s.size)))
    conv = step_convolve(s, r)
    peaks = find_peaks(conv)
    if peaks.size:
        prom = peak_prominences(conv, peaks)
        thresh = np.percentile(prom, prominence_percentile)
        keep = peaks[prom >= thresh]
        # A boundary must mark an actual jump in the sorted times (the
        # convolution peak detects "a large increase", §IV-A); on
        # structureless data the top-percentile filter alone admits
        # ties between float-rounding micro-peaks.
        if keep.size and s.size > 1:
            diffs = np.diff(s)
            med = np.median(diffs)
            keep = keep[diffs[np.clip(keep, 0, diffs.size - 1)]
                        > 3.0 * med]
    else:
        keep = peaks
    boundaries = np.sort(keep)
    # Label sorted positions, then scatter back to input order:
    # position i's class = number of boundaries strictly below i.
    sorted_labels = np.searchsorted(boundaries, np.arange(s.size),
                                    side="left").astype(np.int64)
    labels = np.empty(s.size, dtype=np.int64)
    labels[order] = sorted_labels
    return Labeling(order=order, sorted_times=s, convolution=conv,
                    boundaries=boundaries, labels=labels,
                    n_classes=int(sorted_labels.max()) + 1 if s.size else 0)
