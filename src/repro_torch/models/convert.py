"""Weights carried across from the JAX package.

:func:`params_from_jax` takes the tree that the reference's ``LM.init``
returns, as nested dicts of numpy arrays, and gives the port's
``state_dict`` for it: the ``decoder`` stage's leading period axis is
unstacked into one entry per layer (layer ``period * P + i`` takes slot
``i`` of period ``period``, P the period's length) and each Spec path
becomes the parameter of the same dotted name. :func:`tree_from_jax`
does the same for any tree of that shape (gradients, the optimizer's
moments), as numpy arrays, so the two packages compare name by name.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.model import LM


def _flatten(tree, prefix: str = "") -> dict:
    if not isinstance(tree, dict):
        return {prefix: tree}
    out = {}
    for k, v in tree.items():
        out.update(_flatten(v, f"{prefix}.{k}" if prefix else str(k)))
    return out


def tree_from_jax(tree: dict, model: LM) -> dict[str, np.ndarray]:
    """A tree shaped like the reference's parameters (its parameters,
    their gradients, an optimizer moment) as numpy arrays under
    ``model``'s parameter names, the ``decoder`` stage unstacked. Raises
    ``KeyError`` for a leaf the model has no parameter for or a
    parameter no leaf fills, ``ValueError`` for a leaf of the wrong
    shape."""
    want = {k: tuple(p.shape) for k, p in model.state_dict().items()}
    width = len(model.specs()["decoder"])      # layers in a period
    n_periods = model.cfg.n_layers // width
    out: dict[str, np.ndarray] = {}
    for path, leaf in _flatten(tree).items():
        arr = np.asarray(leaf)
        stage, _, rest = path.partition(".")
        items = [(path, arr)]
        if stage == "decoder":
            if arr.shape[:1] != (n_periods,):
                raise ValueError(
                    f"params_from_jax: {path} has the shape "
                    f"{tuple(arr.shape)}, not {n_periods} stacked periods")
            slot, _, name = rest.partition(".")
            items = [(f"decoder.{per * width + int(slot)}.{name}", arr[per])
                     for per in range(n_periods)]
        for key, a in items:
            if key not in want:
                raise KeyError(f"params_from_jax: {path} has no parameter "
                               f"{key} in the model")
            if tuple(a.shape) != want[key]:
                raise ValueError(
                    f"params_from_jax: {path} gives {key} the shape "
                    f"{tuple(a.shape)}, the model's is {want[key]}")
            out[key] = a
    missing = sorted(set(want) - set(out))
    if missing:
        raise KeyError(f"params_from_jax: no leaf for {missing}")
    return out


def params_from_jax(tree: dict, model: LM) -> dict[str, torch.Tensor]:
    """The JAX parameter tree as ``model``'s state, on its device and in
    its parameter dtype (:func:`tree_from_jax`'s names and checks)."""
    want = model.state_dict()
    return {k: torch.from_numpy(np.array(a, np.float32)).to(
                device=want[k].device, dtype=want[k].dtype)
            for k, a in tree_from_jax(tree, model).items()}
