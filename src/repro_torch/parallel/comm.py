"""Collectives over the named axes of a ``DeviceMesh``, and the four
differentiable ones that tensor and expert parallelism are written with
(Megatron's pairs), for code that keeps activations whole on each rank:

* ``enter(x, axis)``:   forward identity, backward all-reduce (sum): a
  whole tensor going into work that each rank of ``axis`` does on its own
  part, so that its gradient adds up the ranks' parts;
* ``reduce(x, axis)``:  forward all-reduce (sum), backward identity: the
  ranks' partial results added into the whole one;
(both sums run in float32 and round once to the tensor's dtype)
* ``split(x, dim, axis)``:  forward this rank's block of ``dim``, backward
  all-gather of the blocks' gradients;
* ``gather(x, dim, axis)``: forward all-gather along ``dim``, backward
  this rank's block.

Each is the identity, and makes no call, on an axis of size 1 or without
an active mesh, so a (1, 1) mesh computes what no mesh does, bit for bit.
An axis that the mesh lacks has size 1. ``axes`` may name several axes
(the data axes ``("pod", "data")``): a reduction then runs over each in
turn.

``RecordingMesh`` stands in for a ``DeviceMesh`` where no process runs
(the dry run of ``launch.dryrun``): axis names and sizes from a mesh
description, seen from rank 0. ``all_reduce_`` and ``all_gather``
over it, which every collective of the port's sharded step goes through
(these four, the parameter gather of ``sharding.gather_tree`` and the
step's loss and gradient reductions), make no call: each appends its kind
and the bytes of its result on one device to the mesh's ``records`` and
returns a tensor of the result's shape.
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple, Union

import torch
import torch.distributed as dist

from repro_torch.parallel.sharding import current_mesh, describe

Axes = Union[str, Sequence[str]]


class RecordingMesh:
    """A mesh description in a ``DeviceMesh``'s place, seen from rank 0:
    the names and sizes that the sharding code reads, no process group.
    The collectives over it are recorded in ``records``, a list of (kind,
    bytes of the result on one device) with the reference's kind names
    ("all-reduce", "all-gather")."""

    def __init__(self, desc):
        desc = describe(desc)
        self.mesh_dim_names = tuple(desc.axis_names)
        self.shape = tuple(desc.sizes)
        self.records = []

    def size(self, dim: int) -> int:
        return self.shape[dim]

    def get_local_rank(self, axis) -> int:
        return 0

    def record(self, kind: str, result: torch.Tensor) -> None:
        self.records.append((kind, result.numel() * result.element_size()))

    def counts(self) -> Dict[str, Dict[str, int]]:
        """The records by kind: {kind: {"count", "bytes"}}, as the
        reference's ``collective_stats`` returns them."""
        return tally(self.records)


def tally(records) -> Dict[str, Dict[str, int]]:
    """(kind, bytes) records summed by kind: {kind: {"count", "bytes"}}."""
    out: Dict[str, Dict[str, int]] = {}
    for kind, nbytes in records:
        st = out.setdefault(kind, {"count": 0, "bytes": 0})
        st["count"] += 1
        st["bytes"] += int(nbytes)
    return out


def _axes(axes: Axes) -> Tuple[str, ...]:
    return (axes,) if isinstance(axes, str) else tuple(axes)


def axis_size(axes: Axes, mesh=None) -> int:
    """The product of the sizes of ``axes`` on ``mesh`` (the active one by
    default); 1 without a mesh, and for an axis the mesh lacks."""
    mesh = current_mesh() if mesh is None else mesh
    if mesh is None:
        return 1
    names = tuple(mesh.mesh_dim_names)
    n = 1
    for a in _axes(axes):
        if a in names:
            n *= mesh.size(names.index(a))
    return n


def axis_rank(axes: Axes, mesh=None) -> int:
    """This rank's index over ``axes`` taken together, the first outermost
    (0 without a mesh)."""
    mesh = current_mesh() if mesh is None else mesh
    if mesh is None:
        return 0
    names = tuple(mesh.mesh_dim_names)
    r = 0
    for a in _axes(axes):
        if a in names:
            r = r * mesh.size(names.index(a)) + mesh.get_local_rank(a)
    return r


def _over(axes: Axes, mesh):
    """(the mesh, the sizes of the axes of ``axes`` larger than 1 on it)."""
    mesh = current_mesh() if mesh is None else mesh
    if mesh is None:
        return None, []
    names = tuple(mesh.mesh_dim_names)
    return mesh, [(a, mesh.size(names.index(a))) for a in _axes(axes)
                  if a in names and mesh.size(names.index(a)) > 1]


def all_reduce_(x: torch.Tensor, axes: Axes, op=dist.ReduceOp.SUM,
                mesh=None) -> torch.Tensor:
    """``x`` reduced in place over ``axes`` (not differentiable)."""
    mesh, over = _over(axes, mesh)
    for a, _ in over:
        if isinstance(mesh, RecordingMesh):
            mesh.record("all-reduce", x)
        else:
            dist.all_reduce(x, op=op, group=mesh.get_group(a))
    return x


def all_gather(x: torch.Tensor, dim: int, axes: Axes,
               mesh=None) -> torch.Tensor:
    """The ranks' ``x`` concatenated along ``dim`` over ``axes``, the first
    axis outermost (not differentiable)."""
    mesh, over = _over(axes, mesh)
    for a, n in reversed(over):
        if isinstance(mesh, RecordingMesh):
            shape = list(x.shape)
            shape[dim] *= n
            x = x.new_empty(shape)
            mesh.record("all-gather", x)
            continue
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x.contiguous(), group=mesh.get_group(a))
        x = torch.cat(parts, dim=dim)
    return x


def block(x: torch.Tensor, dim: int, axes: Axes, mesh=None) -> torch.Tensor:
    """This rank's block of ``x`` along ``dim`` over ``axes`` (a view)."""
    n = axis_size(axes, mesh)
    if n == 1:
        return x
    w = x.shape[dim] // n
    return x.narrow(dim, axis_rank(axes, mesh) * w, w)


class _Enter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes, mesh):
        ctx.axes, ctx.mesh = axes, mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, dy):
        return _sum(dy, ctx.axes, ctx.mesh), None, None


def _sum(x: torch.Tensor, axes, mesh) -> torch.Tensor:
    """The ranks' ``x`` added in float32 and rounded once to its dtype."""
    y = x.to(torch.float32, copy=True).contiguous()   # NCCL: contiguous
    return all_reduce_(y, axes, mesh=mesh).to(x.dtype)


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes, mesh):
        return _sum(x, axes, mesh)

    @staticmethod
    def backward(ctx, dy):
        return dy, None, None


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, axes, mesh):
        ctx.dim, ctx.axes, ctx.mesh = dim, axes, mesh
        return block(x, dim, axes, mesh)

    @staticmethod
    def backward(ctx, dy):
        return all_gather(dy, ctx.dim, ctx.axes, ctx.mesh), None, None, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, axes, mesh):
        ctx.dim, ctx.axes, ctx.mesh = dim, axes, mesh
        return all_gather(x, dim, axes, mesh)

    @staticmethod
    def backward(ctx, dy):
        return (block(dy, ctx.dim, ctx.axes, ctx.mesh).contiguous(), None,
                None, None)


# the mesh is the one active when the forward runs: the backward, which may
# run after the ``use_mesh`` block has closed, reduces over the same groups


def enter(x: torch.Tensor, axes: Axes) -> torch.Tensor:
    if axis_size(axes) == 1:
        return x
    return _Enter.apply(x, _axes(axes), current_mesh())


def reduce(x: torch.Tensor, axes: Axes) -> torch.Tensor:
    if axis_size(axes) == 1:
        return x
    return _Reduce.apply(x, _axes(axes), current_mesh())


def split(x: torch.Tensor, dim: int, axes: Axes) -> torch.Tensor:
    if axis_size(axes) == 1:
        return x
    return _Split.apply(x, dim, _axes(axes), current_mesh())


def gather(x: torch.Tensor, dim: int, axes: Axes) -> torch.Tensor:
    if axis_size(axes) == 1:
        return x
    return _Gather.apply(x, dim, _axes(axes), current_mesh())


def data_axes(mesh=None) -> Tuple[str, ...]:
    """The axes that carry the batch: ``("pod", "data")`` on a multi-pod
    mesh, else ``("data",)``."""
    mesh = current_mesh() if mesh is None else mesh
    names = () if mesh is None else tuple(mesh.mesh_dim_names)
    return ("pod", "data") if "pod" in names else ("data",)
