"""Elastic re-meshing: resume a state under a different mesh.

Port of ``repro/ft/elastic.py``. Checkpoints store logical (unsharded)
tensors, so scaling from e.g. (data=16, model=16) to (data=14,
model=16) after losing nodes is a re-placement: rebuild placements from
the same logical-axis rules against the new mesh and distribute. A
dimension that no longer divides replicates rather than failing (the
rules engine's safeguard). Moving the bytes is what the gather of each
leaf and its ``distribute_tensor`` express.
"""
from __future__ import annotations

from typing import Any, Mapping

import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, distribute_tensor

from repro_torch.device import resolve_device
from repro_torch.dist import sharding as shd


def remesh_state(state, axes_tree, new_mesh: DeviceMesh,
                 rules: Mapping[str, Any] | None = None):
    """Re-place a (params-like) dict tree under ``new_mesh``: each leaf
    gathered whole (a DTensor's ``full_tensor()``; a plain tensor is
    whole already) and distributed under its new placements."""
    placements = shd.tree_shardings(axes_tree, new_mesh, rules, state)

    def place(leaf, pl):
        if isinstance(leaf, dict):
            return {k: place(leaf[k], pl[k]) for k in leaf}
        whole = leaf.full_tensor() if isinstance(leaf, DTensor) else leaf
        return distribute_tensor(whole, new_mesh, list(pl))

    return place(state, placements)


def degraded_mesh(mesh_or_ranks, axis_names: tuple[str, ...], lost: int,
                  device_type: str | None = None) -> DeviceMesh:
    """Largest rectangular mesh after losing ``lost`` devices.

    Shrinks the leading (data) axis, the standard recovery shape,
    keeps the trailing axes' extents and drops the remainder devices.
    ``mesh_or_ranks`` is a DeviceMesh or an array of ranks in the old
    mesh's shape. The new mesh is on ``device_type``: by default the old
    DeviceMesh's, and the cards where only ranks are given (raises
    without a card).
    """
    ranks = torch.as_tensor(mesh_or_ranks.mesh
                            if isinstance(mesh_or_ranks, DeviceMesh)
                            else mesh_or_ranks)
    rest = 1
    for s in ranks.shape[1:]:
        rest *= s
    lead = (ranks.numel() - lost) // rest
    if lead < 1:
        raise ValueError("not enough devices left for the mesh")
    keep = ranks.reshape(-1)[:lead * rest].reshape(lead, *ranks.shape[1:])
    if device_type is None:
        device_type = mesh_or_ranks.device_type if isinstance(
            mesh_or_ranks, DeviceMesh) else "cuda"
    return DeviceMesh(resolve_device(device_type).type, keep,
                      mesh_dim_names=axis_names)
