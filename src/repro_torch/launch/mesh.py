"""Mesh builders, as the reference's ``repro/launch/mesh.py``.

``make_production_mesh`` returns a *description* (``MeshDesc``: axis names
and sizes) of the production meshes, which the sharding rules and the
dry-run read without 256 or 512 processes: the dry run runs the sharded
step over it as a ``parallel.comm.RecordingMesh``, which counts the
collectives one device would call. ``make_mesh`` and
``make_host_mesh`` build a real ``torch.distributed`` ``DeviceMesh`` over
the processes that were started (``torchrun``, or workers that called
``init_process_group`` themselves): NCCL on the card, gloo only when the
caller asks for the CPU. They are functions, never module-level
constants, so importing this module starts nothing.
"""
from __future__ import annotations

import math
import os
from typing import Sequence

import torch
import torch.distributed as dist

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.parallel.sharding import MeshDesc


def make_production_mesh(*, multi_pod: bool = False) -> MeshDesc:
    """Single pod: 16x16 = 256 chips ("data", "model").
    Multi-pod: 2x16x16 = 512 chips ("pod", "data", "model")."""
    if multi_pod:
        return MeshDesc(("pod", "data", "model"), (2, 16, 16))
    return MeshDesc(("data", "model"), (16, 16))


def init_distributed(device: DeviceLike = None, *, init_method=None,
                     rank=None, world_size=None) -> torch.device:
    """Start the default process group unless one is running, and return
    this process's device: ``cuda:<LOCAL_RANK>`` under ``torchrun``, else
    the current CUDA device (a worker that chose its card already), with
    NCCL; the CPU with gloo when ``device="cpu"``. Without ``init_method``
    the rank, world size and address come from the environment
    (``torchrun``)."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", int(os.environ["LOCAL_RANK"])
                           if "LOCAL_RANK" in os.environ
                           else torch.cuda.current_device())
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        kw = {}
        if init_method is not None:
            kw = dict(init_method=init_method, rank=rank,
                      world_size=world_size)
        if dev.type == "cuda":
            kw["device_id"] = dev
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                **kw)
    return dev


def make_mesh(shape: Sequence[int], axes: Sequence[str],
              device: DeviceLike = None):
    """A ``DeviceMesh`` of ``shape`` with dims named ``axes`` over the
    started processes (their number must be the product of ``shape``),
    ranks laid out row-major."""
    from torch.distributed.device_mesh import init_device_mesh
    dev = init_distributed(device)
    n = math.prod(shape)
    if dist.get_world_size() != n:
        raise ValueError(f"mesh {tuple(shape)} needs {n} processes, "
                         f"{dist.get_world_size()} were started")
    return init_device_mesh(dev.type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def make_host_mesh(device: DeviceLike = None):
    """Every started process on one "data" axis (tests / examples)."""
    init_distributed(device)
    return make_mesh((dist.get_world_size(),), ("data",), device)
