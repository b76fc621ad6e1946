"""Device meshes over ``torch.distributed`` (the reference's
``launch/mesh.py``).

Functions, not module constants: importing this module touches no
process group (the dry-run sets its fake group up first).  Every
mesh is a ``DeviceMesh`` built by ``init_device_mesh`` over the ranks of
the default process group, on ``cuda`` unless the caller asks for
another device type (``cpu`` for gloo and the fake group).  Without a
GPU, a call that does not name a device raises.
"""
from __future__ import annotations

import os

import torch

from repro_torch import device as dv

__all__ = ["make_mesh_auto", "make_production_mesh", "make_local_mesh"]


def _device_type(device) -> str:
    return dv.resolve(device).type if device is None else \
        torch.device(device).type


def make_mesh_auto(shape, axes, *, device=None):
    """A ``DeviceMesh`` of ``shape`` with axis names ``axes`` over the
    default process group's ranks, in rank order."""
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(_device_type(device), tuple(shape),
                            mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False, device=None):
    """16x16 ("data", "model"), or 2x16x16 ("pod", "data", "model"): a
    process group of 256 (512) ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh_auto(shape, axes, device=device)


def make_local_mesh(data: int = 1, model: int = 1, *, device=None):
    """A small ("data", "model") mesh over the ranks that exist: ``data``
    and ``model`` are clamped to the default group's size, as the
    reference clamps them to ``jax.devices()``.  Without a default group
    one is started (gloo on the CPU, NCCL on the card): from the
    environment a launcher such as ``torchrun`` sets (``WORLD_SIZE``,
    ``MASTER_ADDR`` ...; each rank on the card of its ``LOCAL_RANK``),
    else a one-rank group in this process."""
    import torch.distributed as dist

    dtype = _device_type(device)
    if not dist.is_initialized():
        backend = "nccl" if dtype == "cuda" else "gloo"
        if "WORLD_SIZE" in os.environ:
            if dtype == "cuda":
                torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
            dist.init_process_group(backend)
        else:
            dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                    world_size=1)
    n = dist.get_world_size()
    data = min(data, n)
    model = min(model, n // data)
    return make_mesh_auto((data, model), ("data", "model"), device=dtype)
