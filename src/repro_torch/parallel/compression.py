"""Error-feedback int8 gradient all-reduce (DP traffic compression), as the
reference's ``repro/parallel/compression.py``.

Wire format per tensor: int8 payload + one fp32 scale (shared across the
replica group via a tiny MAX all-reduce), int32 accumulation on receive —
4x less DP bandwidth than bf16 grads, 8x less than fp32. The quantization
error is carried in a residual buffer and re-injected next step (error
feedback), so convergence matches uncompressed SGD/Adam to first order.

Usage, over a process group of data-parallel replicas:
    (g_mean, new_resid) = ef_int8_psum_mean(g_local, resid, group)

This is elementwise work and three collectives (the reference has no
kernel for it either), in torch tensor code.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.optim.adamw import leaves, tree_map
from repro_torch.parallel.comm import block


def int8_payload(x: torch.Tensor, group=None):
    """(q int8, scale): ``x`` (float32) quantized against the amax shared
    over ``group`` (a MAX all-reduce), as it goes on the wire."""
    amax = torch.amax(torch.abs(x))
    dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=group)
    scale = torch.clamp_min(amax, 1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


@torch.no_grad()
def ef_int8_psum_mean(g, resid, group=None):
    """Per-leaf error-feedback int8 all-reduce-mean over ``group`` (a
    ``ProcessGroup``; None, the default group). ``g`` and ``resid`` are
    trees of one structure; returns (mean, new residuals), float32."""
    n = float(dist.get_world_size(group))

    def one(g_leaf, r_leaf):
        x = g_leaf.float() + r_leaf
        q, scale = int8_payload(x, group)
        total = q.to(torch.int32)
        dist.all_reduce(total, op=dist.ReduceOp.SUM, group=group)
        mean = total.float() * scale / n
        # error feedback: x - q * scale rounded once, as XLA fuses it into
        # a multiply-subtract (q * scale is exact in float64, and so is
        # the difference but in ties of the final rounding)
        new_resid = (x.double() - q.double() * scale.double()).float()
        return mean, new_resid

    out = [one(a, b) for a, b in zip(leaves(g), leaves(resid))]
    it_m, it_r = iter([o[0] for o in out]), iter([o[1] for o in out])
    return (tree_map(lambda _: next(it_m), g),
            tree_map(lambda _: next(it_r), g))


def init_residuals(params):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def make_compressed_grad_fn(loss_fn, mesh, axis_name: str = "data"):
    """Wrap a per-replica loss into a compressed-DP gradient function.

    Returns grad_fn(params, batch, resid) -> (loss_mean, grads_mean,
    resid'). Params are replicated across ``axis_name`` of ``mesh`` (a
    ``DeviceMesh``); every rank passes the same global batch and keeps its
    block of dim 0."""
    group = mesh.get_group(axis_name)

    def grad_fn(params, batch, resid):
        local = tree_map(lambda b: block(b, 0, axis_name, mesh), batch)
        flat = leaves(params)
        with torch.enable_grad():
            for t in flat:
                t.requires_grad_(True)
            loss = loss_fn(params, local)
            grads = torch.autograd.grad(loss, flat, allow_unused=True,
                                        materialize_grads=True)
        it = iter(grads)
        g_mean, new_resid = ef_int8_psum_mean(
            tree_map(lambda _: next(it), params), resid, group)
        loss = loss.detach().clone()
        dist.all_reduce(loss, op=dist.ReduceOp.SUM, group=group)
        return loss / dist.get_world_size(group), g_mean, new_resid

    return grad_fn
