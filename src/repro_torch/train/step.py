"""Train-step factory: loss, gradients (accumulated over microbatches),
AdamW and the MoE routing-bias update, as the reference's
``repro/train/step.py``.

``make_train_step(cfg, ...)`` returns ``(lm, step)`` with
    step(params, opt_state, batch, stepno) -> (params, opt_state, metrics)
where ``params`` and ``opt_state`` are updated in place (``adamw_update``)
and returned. The gradients go through the model's hand-written kernels on
the card (``kernels.flash_attention``, ``kernels.ssm_scan``: their backward
kernels) and through their plain versions on the CPU. A MoE configuration's
step then nudges each layer's routing bias against the load it saw
(``update_moe_bias``) and reports ``moe_balance``. MLA's attention, whose
value head dim differs from its query/key one, trains through the same
backward kernel (its (192, 128) and (32, 16) instantiations).

With ``mesh`` (a ``DeviceMesh`` with dims named "data" and "model", and
"pod" for a multi-pod one) the step is sharded, as the reference's step
under ``in_shardings``:
- ``init_train_state`` places the parameters and AdamW moments by
  ``param_pspec_tree`` and ``opt_pspec_tree`` (FSDP over the data axes,
  heads / d_ff / experts / vocab over "model"): ``DTensor`` trees whose
  ranks hold their blocks;
- every rank passes the same global batch and keeps its block of the
  batch dim over the data axes (``batch_pspec_tree``);
- the step gathers the parameters, runs the loss under ``use_mesh``
  (attention, SSM, MLP and MoE split over "model", ``parallel.comm``),
  averages the loss and the gradients over the data axes, clips by the
  norm of the whole gradient, and runs AdamW and the routing-bias update
  on each rank's blocks.
The loss, gradients, AdamW and ``moe_balance`` are the single-card step's
up to the order of the sums; a (1, 1) mesh is the single-card step bit for
bit.
"""
from __future__ import annotations

from typing import Optional

import torch

import numpy as np
import torch.distributed as dist

from repro_torch.device import DeviceLike
from repro_torch.models import LM, build_plan
from repro_torch.optim.adamw import (AdamWConfig, adamw_init, adamw_update,
                                     cosine_schedule, leaves, tree_map)
from repro_torch.parallel import comm
from repro_torch.parallel.sharding import (batch_pspec_tree, from_local_tree,
                                           gather_tree, local_block,
                                           local_tree, map_tree,
                                           opt_pspec_tree,
                                           param_pspec_tree, spec_tree,
                                           use_mesh)

MOE_BIAS_LR = 1e-3


@torch.no_grad()
def update_moe_bias(cfg, params, load):
    """DeepSeek's aux-loss-free balancing: each MoE layer's routing bias
    moves by ``MOE_BIAS_LR`` against the sign of its load's deviation from
    the layer's mean. ``load`` (L_moe, E) stacks the MoE layers in plan
    order (``LM.loss``'s ``moe_load``). Updates ``params`` in place and
    returns it."""
    row = 0
    for seg in build_plan(cfg):
        if seg.kind != "moe":
            continue
        seg_load = load[row:row + len(seg.layers)]
        row += len(seg.layers)
        mean = seg_load.mean(dim=-1, keepdim=True)
        params[seg.name]["moe"]["bias"].add_(
            MOE_BIAS_LR * torch.sign(mean - seg_load))
    return params


def _split(batch, n: int):
    """``batch`` cut along its leading axis into ``n`` equal microbatches."""
    def cut(x, i):
        m = x.shape[0] // n
        return x[i * m:(i + 1) * m]
    return [{k: cut(v, i) for k, v in batch.items()} for i in range(n)]


def make_train_step(cfg, *, base_lr: float = 3e-4, warmup: int = 200,
                    total_steps: int = 10_000,
                    acfg: AdamWConfig = AdamWConfig(), remat: str = "full",
                    microbatch: Optional[int] = None,
                    device: DeviceLike = None, mesh=None):
    """(lm, step) for ``cfg`` on ``device`` (the CUDA device unless
    ``"cpu"``). With ``microbatch``, the batch is split into B / microbatch
    parts whose gradients are summed in float32 and divided by their
    number, and the loss is their mean. With ``mesh``, the sharded step of
    the module docstring (``microbatch`` then splits each rank's block)."""
    lm = LM(cfg, device)
    lr_fn = cosine_schedule(base_lr, warmup, total_steps)

    def value_and_grad(params, batch):
        flat = leaves(params)
        for t in flat:
            t.requires_grad_(True)
        loss, metrics = lm.loss(params, batch, remat=remat)
        # the MoE routing bias only selects (top-k): its gradient is zero
        grads = torch.autograd.grad(loss, flat, allow_unused=True,
                                    materialize_grads=True)
        it = iter(grads)
        return (loss.detach(), {k: v.detach() for k, v in metrics.items()}), \
            tree_map(lambda _: next(it), params)

    def grads_of(params, batch):
        if microbatch is None:
            return value_and_grad(params, batch)
        n = next(iter(batch.values())).shape[0] // microbatch
        gsum, losses, ms = None, [], []
        for part in _split(batch, n):
            (loss, metrics), g = value_and_grad(params, part)
            gsum = tree_map(lambda a: a.float(), g) if gsum is None else \
                tree_map(lambda s, a: s.add_(a), gsum, g)
            losses.append(loss)
            ms.append(metrics)
        grads = tree_map(lambda s: s / n, gsum)
        metrics = {k: torch.stack([m[k] for m in ms]).mean(0) for k in ms[0]}
        return (torch.stack(losses).mean(), metrics), grads

    def step(params, opt_state, batch, stepno):
        (loss, metrics), grads = grads_of(params, batch)
        lr = lr_fn(stepno)
        params, opt_state, gnorm = adamw_update(grads, opt_state, params, lr,
                                                acfg)
        if "moe_load" in metrics:
            load = metrics.pop("moe_load")
            update_moe_bias(cfg, params, load)
            metrics["moe_balance"] = torch.std(load.mean(0), correction=0)
        return params, opt_state, {**metrics, "grad_norm": gnorm, "lr": lr}

    if mesh is None:
        return lm, step

    data = comm.data_axes(mesh)
    dp = comm.axis_size(data, mesh)

    def sharded_step(params, opt_state, batch, stepno):
        pspecs, ospecs = spec_tree(params), spec_tree(opt_state)
        bspecs = batch_pspec_tree(mesh, batch)
        local_batch = {k: local_block(mesh, bspecs[k], _tensor(v, lm.device))
                       for k, v in batch.items()}
        with torch.no_grad():
            full = gather_tree(params)
        with use_mesh(mesh):
            (loss, metrics), grads = grads_of(full, local_batch)
        del full
        if dp > 1:
            loss = comm.all_reduce_(loss.clone(), data, mesh=mesh) / dp
            metrics["loss"] = loss
        # the gradient: averaged over the data axes (in float32), its norm
        # taken whole, then each rank's blocks
        sq, g_local = None, []
        for g, s in zip(leaves(grads), leaves(pspecs)):
            if dp > 1:
                g = comm.all_reduce_(g.float().contiguous(), data,
                                     mesh=mesh) / dp
            part = torch.sum(torch.square(g.float()))   # global_norm's order
            sq = part if sq is None else sq + part
            g_local.append(local_block(mesh, s, g).clone())  # g is freed
        grads = None
        it = iter(g_local)
        g_local = tree_map(lambda _: next(it), pspecs)
        gnorm = torch.sqrt(sq)
        p_local, o_local = local_tree(params), local_tree(opt_state)
        row_max = [_row_max(mesh, s) for s in leaves(pspecs)] \
            if acfg.quantized else None
        lr = lr_fn(stepno)
        adamw_update(g_local, o_local, p_local, lr, acfg, gnorm=gnorm,
                     row_max=row_max)
        if "moe_load" in metrics:
            load = metrics.pop("moe_load")
            update_moe_bias(cfg, p_local, load)
            metrics["moe_balance"] = torch.std(load.mean(0), correction=0)
        return (from_local_tree(mesh, p_local, pspecs),
                from_local_tree(mesh, o_local, ospecs),
                {**metrics, "grad_norm": gnorm, "lr": lr})

    return lm, sharded_step


def _tensor(x, device) -> torch.Tensor:
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.asarray(x))
    return x.to(device)  # noqa: HS01 (the batch to the card)


def _row_max(mesh, spec):
    """The row-amax reduction of a leaf whose last dim ``spec`` splits
    (None if it does not)."""
    entry = spec[-1] if len(spec) else None
    axes = () if entry is None else (
        entry if isinstance(entry, tuple) else (entry,))
    if comm.axis_size(axes, mesh) == 1:
        return None
    return lambda amax: comm.all_reduce_(amax.clone(), axes,
                                         op=dist.ReduceOp.MAX, mesh=mesh)


def init_train_state(cfg, generator: Optional[torch.Generator] = None,
                     acfg: AdamWConfig = AdamWConfig(),
                     device: DeviceLike = None, mesh=None):
    """(params, opt_state): parameters drawn from ``generator`` (a
    ``torch.Generator`` on ``device``) and zero AdamW moments. With
    ``mesh``, every rank draws the same parameters from a generator seeded
    alike and keeps its blocks: ``DTensor`` trees placed by
    ``param_pspec_tree`` and ``opt_pspec_tree``."""
    return place_train_state(LM(cfg, device).init(generator), acfg, mesh)


def place_train_state(params, acfg: AdamWConfig = AdamWConfig(), mesh=None):
    """(params, zero AdamW moments) of the parameter tree ``params``; with
    ``mesh``, every rank passes the same tree and keeps its blocks, as
    ``init_train_state`` places them."""
    if mesh is None:
        return params, adamw_init(params, acfg)
    pspecs = param_pspec_tree(mesh, params)
    meta = tree_map(lambda p: torch.empty(p.shape, dtype=p.dtype,
                                          device="meta"), params)
    opt_meta = adamw_init(meta, acfg)     # which moments are int8: by the
    ospecs = opt_pspec_tree(mesh, meta, opt_meta)    # whole leaf's size
    dev = leaves(params)[0].device
    p_local = tree_map(lambda p, s: local_block(mesh, s, p).clone(),
                       params, pspecs)
    del params
    o_local = map_tree(lambda m, s: torch.zeros(
        local_block(mesh, s, m).shape, dtype=m.dtype, device=dev),
        opt_meta, ospecs)
    return (from_local_tree(mesh, p_local, pspecs),
            from_local_tree(mesh, o_local, ospecs))

