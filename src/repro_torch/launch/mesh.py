"""Production meshes, as DeviceMeshes.

Port of ``repro/launch/mesh.py``. Defined as functions, so importing
this module touches no process-group state. A mesh needs a default
process group of (at least) its size: NCCL or gloo across processes on
a cluster, or, for the dry run, PyTorch's ``fake`` backend in one
process (:func:`init_fake_group`), where collectives are shapes only.
As the reference's meshes are built on the default backend's devices,
these are built on the cards unless the caller names another device
type (the dry run and the gloo tests pass ``"cpu"``); without a card
that raises before any mesh exists.
"""
from __future__ import annotations

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from repro_torch.device import resolve_device

PRODUCTION = {False: ((16, 16), ("data", "model")),
              True: ((2, 16, 16), ("pod", "data", "model"))}


def init_fake_group(world_size: int) -> None:
    """A default process group of ``world_size`` ranks on the ``fake``
    backend, this process rank 0 (none may exist yet)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda") -> DeviceMesh:
    """16x16 = 256 GPUs per pod; 2 pods = 512 GPUs multi-pod. Needs a
    default group of that size."""
    shape, axes = PRODUCTION[multi_pod]
    return init_device_mesh(resolve_device(device_type).type, shape,
                            mesh_dim_names=axes)


def free_port() -> int:
    """A TCP port on localhost that is free now, for a process group's
    ``init_method`` (``tcp://localhost:<port>``)."""
    import socket

    with socket.socket() as sk:
        sk.bind(("localhost", 0))
        return sk.getsockname()[1]


def make_local_mesh(n_data: int = 1, n_model: int = 1,
                    device_type: str = "cuda") -> DeviceMesh:
    """A small (data, model) mesh over the default group's first
    ``n_data * n_model`` ranks (tests, the one-GPU cell)."""
    return init_device_mesh(resolve_device(device_type).type,
                            (n_data, n_model),
                            mesh_dim_names=("data", "model"))
