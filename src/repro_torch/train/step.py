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
(``update_moe_bias``) and reports ``moe_balance``. MLA's attention has a
value head dim apart from its query/key one, which the backward kernel
does not take yet: training an MLA configuration runs on the CPU only
(ROADMAP.md, queue 2).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.device import DeviceLike
from repro_torch.models import LM, build_plan
from repro_torch.optim.adamw import (AdamWConfig, adamw_init, adamw_update,
                                     cosine_schedule, leaves, tree_map)

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
                    device: DeviceLike = None):
    """(lm, step) for ``cfg`` on ``device`` (the CUDA device unless
    ``"cpu"``). With ``microbatch``, the batch is split into B / microbatch
    parts whose gradients are summed in float32 and divided by their
    number, and the loss is their mean."""
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

    return lm, step


def init_train_state(cfg, generator: Optional[torch.Generator] = None,
                     acfg: AdamWConfig = AdamWConfig(),
                     device: DeviceLike = None):
    """(params, opt_state): parameters drawn from ``generator`` (a
    ``torch.Generator`` on ``device``) and zero AdamW moments."""
    params = LM(cfg, device).init(generator)
    return params, adamw_init(params, acfg)

