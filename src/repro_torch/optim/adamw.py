"""AdamW with global-norm clipping, optionally with int8-quantized moments,
and the cosine learning-rate schedule: the reference's
``repro/optim/adamw.py``.

The state mirrors the parameter tree: ``{"m": tree, "v": tree, "count":
int32 0-d tensor}``; with ``quantized`` a moment of a leaf with at least
1,024 elements is ``{"q": int8, "scale": float32 (..., 1)}``, v kept in
the sqrt domain. Unlike the reference (whose arrays are immutable),
``adamw_update`` writes the new parameters and moments into the given
tensors in place, under ``torch.no_grad()``, so a step holds no second
copy of either; it returns them all the same.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch


class AdamWConfig(NamedTuple):
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    quantized: bool = False


def leaves(tree):
    """The tensors of a nested-dict tree in the reference's leaf order
    (``jax.tree.leaves``: keys sorted)."""
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in leaves(tree[k])]
    return [tree]


def tree_map(fn, *trees):
    """``fn`` over the leaves of nested-dict trees of one structure, called
    in ``leaves`` order."""
    t = trees[0]
    if isinstance(t, dict):
        return {k: tree_map(fn, *(x[k] for x in trees)) for k in sorted(t)}
    return fn(*trees)


def _q8(x):
    """int8 along the last axis: (q, scale)."""
    amax = x.abs().amax(-1, keepdim=True)
    scale = torch.clamp_min(amax, 1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def _dq8(q, scale):
    return q.float() * scale


def _quantizes(p, acfg: AdamWConfig) -> bool:
    return acfg.quantized and p.dim() >= 1 and p.numel() >= 1024


def adamw_init(params, acfg: AdamWConfig = AdamWConfig()):
    def zeros_like_moment(p):
        if _quantizes(p, acfg):
            return {"q": torch.zeros(p.shape, dtype=torch.int8,
                                     device=p.device),
                    "scale": torch.zeros(p.shape[:-1] + (1,),
                                         dtype=torch.float32,
                                         device=p.device)}
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    some = leaves(params)[0]
    return {"m": tree_map(zeros_like_moment, params),
            "v": tree_map(zeros_like_moment, params),
            "count": torch.zeros((), dtype=torch.int32, device=some.device)}


def _is_q8(moment) -> bool:
    return isinstance(moment, dict)


def _load(moment, kind: str):
    if _is_q8(moment):
        x = _dq8(moment["q"], moment["scale"])
        return x * x if kind == "v" else x
    return moment


def _store(val, moment, kind: str) -> None:
    """Write ``val`` into ``moment`` in place; v is quantized in the sqrt
    domain, where Adam consumes it."""
    if _is_q8(moment):
        q, s = _q8(torch.sqrt(torch.clamp_min(val, 0.0)) if kind == "v"
                   else val)
        moment["q"].copy_(q)
        moment["scale"].copy_(s)
    else:
        moment.copy_(val)


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves (in leaf order) of each leaf's sum of
    squares in float32."""
    total = None
    for x in leaves(tree):
        sq = torch.sum(torch.square(x.float()))
        total = sq if total is None else total + sq
    return torch.sqrt(total)


@torch.no_grad()
def adamw_update(grads, state, params, lr, acfg: AdamWConfig = AdamWConfig()):
    """One AdamW step, in place: clip the gradients to ``clip_norm`` by
    their global norm, bias-correct the moments, decay the matrices (a leaf
    of at least 2 dims, the stacked layer axis included). Returns (params,
    state, grad_norm) — the same tensors, updated."""
    gnorm = global_norm(grads)
    scale = torch.clamp_max(
        acfg.clip_norm / torch.clamp_min(gnorm, 1e-12), 1.0)
    state["count"].add_(1)
    count = state["count"].float()
    c1 = 1.0 - torch.pow(torch.tensor(acfg.b1, device=count.device), count)
    c2 = 1.0 - torch.pow(torch.tensor(acfg.b2, device=count.device), count)

    def upd(p, g, m_st, v_st):
        g = g.float() * scale
        m = acfg.b1 * _load(m_st, "m") + (1 - acfg.b1) * g
        v = acfg.b2 * _load(v_st, "v") + (1 - acfg.b2) * g * g
        step = (m / c1) / (torch.sqrt(v / c2) + acfg.eps)
        if p.dim() >= 2:    # decoupled weight decay on matrices only
            step = step + acfg.weight_decay * p.float()
        p.copy_((p.float() - lr * step).to(p.dtype))
        _store(m, m_st, "m")
        _store(v, v_st, "v")

    for p, g, m_st, v_st in zip(leaves(params), leaves(grads),
                                _moment_leaves(state["m"], params),
                                _moment_leaves(state["v"], params)):
        upd(p, g, m_st, v_st)
    return params, state, gnorm


def _moment_leaves(moments, params):
    """The moments in the parameters' leaf order (a quantized moment, a
    dict of q and scale, stays one entry)."""
    if isinstance(params, dict):
        return [m for k in sorted(params)
                for m in _moment_leaves(moments[k], params[k])]
    return [moments]


def cosine_schedule(base_lr: float, warmup: int, total: int,
                    min_frac: float = 0.1):
    """lr(step): linear warmup from 0 over ``warmup`` steps, then a cosine
    to ``min_frac * base_lr`` at ``total``; in float32, as the reference
    computes it, returned as a Python float."""
    def lr(step) -> float:
        f32 = dict(dtype=torch.float32)
        step = torch.tensor(float(step), **f32)
        w = torch.clamp_max(step / max(warmup, 1), 1.0)
        t = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = min_frac + (1 - min_frac) * 0.5 * (
            1 + torch.cos(torch.tensor(math.pi, **f32) * t))
        return float(base_lr * w * cos)
    return lr
