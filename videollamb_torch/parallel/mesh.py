"""Device meshes over the ranks of a ``torch.distributed`` job.

Port of ``videollamb_tpu/parallel/mesh.py``. The JAX package lays one
process's devices out in a mesh; here every card is a rank of its own
(``torchrun``, one process a card) and the mesh is a
``torch.distributed.device_mesh.DeviceMesh`` over the world's ranks, on
``cuda`` (NCCL) or on ``cpu`` (gloo). Data parallelism and FSDP ride the
``data`` axis, tensor parallelism the ``model`` axis
(``parallel/sharding.py``); the multi-host mesh adds a ``replica`` axis
across hosts, over which the parameters are replicated and the gradients
averaged (FSDP2's hybrid sharding).
"""

from __future__ import annotations

import os
from typing import Optional

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def mesh_device_type() -> str:
    """``cpu`` under gloo, ``cuda`` otherwise."""
    return "cpu" if dist.get_backend() == "gloo" else "cuda"


def create_mesh(data_parallel: Optional[int] = None, model_parallel: int = 1, *,
                axis_names: tuple = ("data", "model")) -> DeviceMesh:
    """A ('data', 'model') mesh over the world's ranks; rank r sits at
    (r // model_parallel, r % model_parallel). ``data_parallel`` defaults to
    world // model_parallel."""
    n = dist.get_world_size()
    if data_parallel is None:
        if n % model_parallel:
            raise ValueError(f"{n} ranks do not divide into model_parallel={model_parallel}")
        data_parallel = n // model_parallel
    if data_parallel * model_parallel != n:
        raise ValueError(f"mesh {data_parallel} x {model_parallel} needs {n} ranks")
    return init_device_mesh(mesh_device_type(), (data_parallel, model_parallel),
                            mesh_dim_names=axis_names)


def create_multislice_mesh(model_parallel: int = 1, *, n_slices: Optional[int] = None,
                           axis_names: tuple = ("replica", "data", "model")) -> DeviceMesh:
    """A ('replica', 'data', 'model') mesh: pure data parallelism across
    slices (hosts: ``n_slices`` defaults to world // LOCAL_WORLD_SIZE, one on
    a single host), FSDP and tensor parallelism within a slice."""
    n = dist.get_world_size()
    if n_slices is None:
        n_slices = max(1, n // int(os.environ.get("LOCAL_WORLD_SIZE", n)))
    per_slice = n // n_slices
    if per_slice * n_slices != n or per_slice % model_parallel:
        raise ValueError(f"{n} ranks do not split into {n_slices} slices of "
                         f"model_parallel={model_parallel}")
    return init_device_mesh(mesh_device_type(),
                            (n_slices, per_slice // model_parallel, model_parallel),
                            mesh_dim_names=axis_names)
