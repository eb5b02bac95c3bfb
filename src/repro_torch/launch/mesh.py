"""Device meshes over ``torch.distributed``.

The port of ``repro/launch/mesh.py``.  One process per rank (SPMD): every
rank calls ``make_mesh`` with the same shape and axis names, and gets a
``DeviceMesh`` whose ``mesh_dim_names`` are the reference's axis names
(``("data", "model")``, or ``("pod", "data", "model")`` multi-pod).  The
process group must already span the mesh (``init_process_group`` with
its own address, world size and rank: nothing here reads a cluster's
environment).  On ``device_type="cuda"`` (the default) a rank binds
its own card first: ``LOCAL_RANK`` when set, else its rank modulo the
cards it sees.  The tests pass ``device_type="cpu"`` and a gloo group.  A shape whose product
differs from the world size raises: a mesh never shrinks quietly.
Functions, not module-level constants: importing this module touches no
device and no process group.
"""

from __future__ import annotations

import math
import os

import torch
import torch.distributed as dist

from repro_torch.kernels.dispatch import require_device
from repro_torch.sharding.rules import axis_names


def _bind(device_type: str) -> None:
    """Check the device and, on CUDA, make this rank's card current."""
    require_device(device_type)
    if device_type == "cuda":
        local = os.environ.get("LOCAL_RANK")
        rank = dist.get_rank() if dist.is_initialized() else 0
        torch.cuda.set_device(int(local) if local is not None
                              else rank % torch.cuda.device_count())


def make_mesh(shape: tuple, axes: tuple, *, device_type: str = "cuda"):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over the world's ranks
    in rank order (the last axis fastest, as ``jax.make_mesh`` lays out
    devices)."""
    from torch.distributed.device_mesh import init_device_mesh

    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in "
                         "length")
    _bind(device_type)
    if not dist.is_initialized():
        raise RuntimeError(
            f"a {shape} mesh needs a process group of {math.prod(shape)} "
            "ranks; call torch.distributed.init_process_group first")
    world = dist.get_world_size()
    if math.prod(shape) != world:
        raise ValueError(f"mesh {dict(zip(axes, shape))} needs "
                         f"{math.prod(shape)} ranks; the world has {world}")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """The reference's production layouts: 16 x 16 ``(data, model)``, or
    2 x 16 x 16 ``(pod, data, model)``; they need a world of 256 or 512
    ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device_type=device_type)


def dp_axes(mesh) -> tuple:
    return ("pod", "data") if "pod" in axis_names(mesh) else ("data",)


def n_chips(mesh) -> int:
    return mesh.size()
