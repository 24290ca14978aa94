"""Step-granular checkpointing: async and atomic.

Port of ``repro/checkpoint/store.py``, with its layout:
``<dir>/step-<N>/arrays.npz`` + ``meta.json``, then ``<dir>/LATEST``
written last by an atomic rename, so a crash mid-write never corrupts
the restore path; ``keep_last`` old steps are kept. The arrays are
named by their tree paths joined with ``/`` (dict keys, list indices),
as the reference names them, so either package restores a directory the
other wrote. The port flattens nested dicts, lists and tuples of
tensors, numpy arrays and scalars itself: every tensor is copied to the
host (bfloat16 widened to float32, which is exact) before the async
writer thread starts, so the caller may update it in place at once.
``restore`` gives each leaf the dtype, and for a tensor the device, of
the tree it is shaped like.
"""
from __future__ import annotations

import json
import os
import pathlib
import shutil
import threading

import numpy as np
import torch


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach()
        if leaf.dtype == torch.bfloat16:
            leaf = leaf.float()
        return leaf.cpu().numpy().copy()
    return np.array(leaf)


def _items(tree, prefix: str = ""):
    """(path, leaf) in the tree's order."""
    if isinstance(tree, dict):
        children = tree.items()
    elif isinstance(tree, (list, tuple)):
        children = enumerate(tree)
    else:
        yield prefix, tree
        return
    for k, v in children:
        yield from _items(v, f"{prefix}/{k}" if prefix else str(k))


def _flatten(tree) -> dict[str, np.ndarray]:
    return {path: _host(leaf) for path, leaf in _items(tree)}


def _restore_leaf(like, arr: np.ndarray):
    if isinstance(like, torch.Tensor):
        return torch.from_numpy(arr).to(device=like.device,
                                        dtype=like.dtype)
    return arr.astype(like.dtype) if hasattr(like, "dtype") else arr


def _unflatten(tree_like, flat: dict[str, np.ndarray], prefix: str = ""):
    def path(k):
        return f"{prefix}/{k}" if prefix else str(k)
    if isinstance(tree_like, dict):
        return {k: _unflatten(v, flat, path(k))
                for k, v in tree_like.items()}
    if isinstance(tree_like, (list, tuple)):
        return type(tree_like)(_unflatten(v, flat, path(i))
                               for i, v in enumerate(tree_like))
    return _restore_leaf(tree_like, flat[prefix])


class CheckpointStore:
    def __init__(self, directory: str | os.PathLike, keep_last: int = 3):
        self.dir = pathlib.Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep_last = keep_last
        self._worker: threading.Thread | None = None

    # -- write ------------------------------------------------------------
    def save(self, step: int, state: dict, blocking: bool = True,
             extra_meta: dict | None = None) -> None:
        flat = _flatten(state)
        meta = {"step": int(step), **(extra_meta or {})}
        if blocking:
            self._write(step, flat, meta)
        else:
            self.wait()
            self._worker = threading.Thread(
                target=self._write, args=(step, flat, meta), daemon=True)
            self._worker.start()

    def wait(self) -> None:
        if self._worker is not None:
            self._worker.join()
            self._worker = None

    def _write(self, step: int, flat: dict, meta: dict) -> None:
        tmp = self.dir / f".tmp-step-{step}"
        final = self.dir / f"step-{step}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir()
        np.savez(tmp / "arrays.npz", **flat)
        (tmp / "meta.json").write_text(json.dumps(meta))
        if final.exists():
            shutil.rmtree(final)
        tmp.rename(final)
        latest_tmp = self.dir / ".LATEST.tmp"
        latest_tmp.write_text(str(step))
        latest_tmp.rename(self.dir / "LATEST")  # atomic publish
        self._gc()

    def _gc(self) -> None:
        steps = sorted(self.steps())
        for s in steps[:-self.keep_last]:
            shutil.rmtree(self.dir / f"step-{s}", ignore_errors=True)

    # -- read -------------------------------------------------------------
    def steps(self) -> list[int]:
        return sorted(int(p.name.split("-", 1)[1])
                      for p in self.dir.glob("step-*"))

    def latest_step(self) -> int | None:
        marker = self.dir / "LATEST"
        if marker.exists():
            s = int(marker.read_text())
            if (self.dir / f"step-{s}").exists():
                return s
        steps = self.steps()
        return steps[-1] if steps else None

    def restore(self, tree_like, step: int | None = None):
        """Returns (step, state) re-shaped like ``tree_like``."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        with np.load(self.dir / f"step-{step}" / "arrays.npz") as z:
            flat = {k: z[k] for k in z.files}
        return step, _unflatten(tree_like, flat)

    def meta(self, step: int) -> dict:
        return json.loads(
            (self.dir / f"step-{step}" / "meta.json").read_text())
