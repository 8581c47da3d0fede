"""Mixture-of-Experts block: shared expert(s) + routed top-k with the
sort-based capacity dispatch of ``repro/models/moe.py`` (the reference's
single-program path; its ``shard_map`` expert parallelism belongs to
multi-card training, ROADMAP.md), dropping on overflow.

The router and its gate run in float32; a per-expert bias (DeepSeek's
aux-loss-free balancing, nudged by ``train.step.update_moe_bias``) is
added to the scores for the *selection* only. Entries are sorted by expert
(stably), each gets its rank within its expert, and the first C of an
expert keep a slot of the (E, C, d) buffer, C = ceil8(max(8, N k / E *
capacity_factor)). The expert products are batched matrix products over
that buffer (the reference has no Pallas kernel here).

Two places where the port's order of work is fixed on purpose:
- the dispatch writes each kept entry into its own slot and sends the
  dropped ones to a spare row past the buffer, so that no dropped entry
  lands on a real one (the reference adds them into slot (0, 0) times 0);
- the combine gathers each token's k outputs and adds them one by one in
  the order the reference's scatter-add meets them (by expert), so that
  the result does not depend on the order of atomic adds and two runs on
  the card agree bit for bit.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.common import dense_init
from repro_torch.models.mlp import init_mlp, mlp_block


def init_moe(gen, cfg, dtype, device):
    d, E, f = cfg.d_model, cfg.num_experts, cfg.moe_d_ff
    p = {
        "router": dense_init(gen, (d, E), torch.float32, device, scale=0.02),
        # aux-free balancing bias: moved by the train step, not by a gradient
        "bias": torch.zeros((E,), dtype=torch.float32, device=device),
        "wg": dense_init(gen, (E, d, f), dtype, device),
        "wu": dense_init(gen, (E, d, f), dtype, device),
        "wd": dense_init(gen, (E, f, d), dtype, device),
    }
    if cfg.n_shared_experts:
        p["shared"] = init_mlp(gen, d, f * cfg.n_shared_experts, "swiglu",
                               dtype, device)
    return p


def _route(p, x2d, cfg):
    """x2d (N, d) -> (expert_ids (N,k), weights (N,k), router_probs (N,E))."""
    logits = x2d.float() @ p["router"]
    if cfg.router_gate == "sigmoid":
        scores = torch.sigmoid(logits)
    else:
        scores = torch.softmax(logits, dim=-1)
    sel = scores + p["bias"][None, :]            # bias affects selection only
    ids = torch.topk(sel, cfg.top_k, dim=-1).indices          # (N, k)
    w = scores.gather(-1, ids)                   # original scores as weights
    w = w / torch.clamp_min(w.sum(-1, keepdim=True), 1e-9)
    return ids, w, scores


def capacity(n_tokens: int, cfg) -> int:
    """Slots per expert: the reference's int(max(8, N k / E * cf)), rounded
    up to a multiple of 8."""
    C = int(max(8, (n_tokens * cfg.top_k / cfg.num_experts)
                * cfg.capacity_factor))
    return -(-C // 8) * 8


def dispatch(ids: torch.Tensor, n_experts: int, C: int):
    """The slot of every (token, choice) entry. ``ids`` (N, k) -> (order,
    s_ids, rank, keep), each (N k,) in expert-sorted order: ``order`` the
    stable sort of the flat ids (entry ``order[j]`` is token ``order[j] //
    k``), ``rank`` the entry's place within its expert, ``keep`` whether
    it got one of the C slots."""
    flat = ids.reshape(-1)
    order = torch.argsort(flat, stable=True)
    s_ids = flat[order]
    start = torch.searchsorted(
        s_ids, torch.arange(n_experts, device=ids.device, dtype=s_ids.dtype))
    rank = torch.arange(flat.numel(), device=ids.device) - start[s_ids]
    return order, s_ids, rank, rank < C


def moe_block(p, x, cfg):
    """x (B,S,d) -> (y (B,S,d), aux dict with load stats)."""
    B, S, d = x.shape
    N, E, k = B * S, cfg.num_experts, cfg.top_k
    x2d = x.reshape(N, d)
    ids, w, probs = _route(p, x2d, cfg)
    C = capacity(N, cfg)
    order, s_ids, rank, keep = dispatch(ids, E, C)
    s_tok = torch.div(order, k, rounding_mode="floor")
    s_w = w.reshape(-1)[order]

    # --- dispatch: kept entries into their slots, dropped ones to row E*C
    slot = torch.where(keep, s_ids * C + rank, E * C)
    xbuf = x2d.new_zeros((E * C + 1, d))
    xbuf[slot] = x2d[s_tok]
    xbuf = xbuf[:E * C].view(E, C, d)

    # --- grouped expert FFN -------------------------------------------------
    g = torch.bmm(xbuf, p["wg"])
    u = torch.bmm(xbuf, p["wu"])
    h = F.silu(g.float()).to(x.dtype) * u
    ybuf = torch.bmm(h, p["wd"]).view(E * C, d)

    # --- combine: each token's k outputs, added in expert order -------------
    y_tok = ybuf[torch.where(keep, slot, 0)] \
        * (s_w * keep).to(x.dtype)[:, None]
    pos = torch.empty_like(order)
    pos[order] = torch.arange(order.numel(), device=x.device)
    y_k = y_tok[pos.view(N, k).sort(dim=1).values]          # (N, k, d)
    y2d = y_k[:, 0]
    for j in range(1, k):
        y2d = y2d + y_k[:, j]
    y = y2d.view(B, S, d)

    if cfg.n_shared_experts:
        y = y + mlp_block(p["shared"], x)

    flat_ids = ids.reshape(-1)
    # times the float32 reciprocal, as XLA divides by a constant: the load
    # is then the reference's bit for bit, and so is the bias update's sign
    load = torch.zeros((E,), dtype=torch.float32, device=x.device).index_add_(
        0, flat_ids, torch.ones(flat_ids.shape, device=x.device)) \
        * (1.0 / (N * k))
    aux = {
        "load": load,                 # fraction of assignments per expert
        "router_entropy": -torch.mean(torch.sum(
            probs * torch.log(probs + 1e-9), dim=-1)),
        "dropped": 1.0 - keep.float().mean(),
    }
    return y, aux
