"""Mixture-of-Experts block: shared expert(s) + routed top-k with the
sort-based capacity dispatch of ``repro/models/moe.py``, dropping on
overflow, and its expert parallelism.

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

Under an active mesh (``parallel.sharding.use_mesh``) the block takes one
of the reference's two paths, chosen as it chooses them, at call time:
- with ``REPRO_MOE_SHARDMAP=1`` and a "model" axis whose size divides E,
  expert parallelism (the reference's ``_moe_block_shardmap``): each rank
  routes its data shard's tokens, dispatches them into its E / ep experts
  with the capacity of its *local* token count, and the (N_local, d)
  partial outputs are summed with one all-reduce over "model"; the shared
  expert has d_ff over "model" and its own all-reduce; ``load`` is the
  mean over "model" and the data axes, divided by the local N k;
  ``router_entropy`` and ``dropped`` are zeros, as the reference returns
  them;
- otherwise the block computes what the unsharded block computes (what
  GSPMD gives the reference): the data shards' tokens are gathered, every
  rank runs the block on all of them and keeps its own rows.
Each rank's partial keeps the combine order above.
"""
from __future__ import annotations

import os

import torch
import torch.nn.functional as F

from repro_torch.models.common import dense_init
from repro_torch.models.mlp import init_mlp, mlp_block
from repro_torch.parallel import comm
from repro_torch.parallel.sharding import current_mesh


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


def dispatch(ids: torch.Tensor, n_experts: int, C: int, offset: int = 0):
    """The slot of every (token, choice) entry. ``ids`` (N, k) -> (order,
    s_ids, rank, keep), each (N k,) in expert-sorted order: ``order`` the
    stable sort of the flat ids (entry ``order[j]`` is token ``order[j] //
    k``), ``s_ids`` the expert less ``offset``, ``rank`` the entry's place
    within its expert, ``keep`` whether it got one of the C slots. With
    ``offset``, only the experts ``offset`` .. ``offset + n_experts - 1``
    take slots: the entries of the others sort last, with ``s_ids`` 0 and
    ``keep`` False."""
    flat = ids.reshape(-1) - offset
    mine = (flat >= 0) & (flat < n_experts)
    key = torch.where(mine, flat, n_experts)
    order = torch.argsort(key, stable=True)
    s_key = key[order]
    start = torch.searchsorted(
        s_key, torch.arange(n_experts, device=ids.device, dtype=s_key.dtype))
    s_mine = s_key < n_experts
    s_ids = torch.where(s_mine, s_key, 0)
    rank = torch.arange(flat.numel(), device=ids.device) - start[s_ids]
    return order, s_ids, rank, s_mine & (rank < C)


def _dispatch_compute_combine(p, x2d, ids, w, cfg, n_experts: int,
                              offset: int = 0):
    """Tokens x2d (N, d) through the experts ``offset`` .. ``offset +
    n_experts - 1``, whose weights ``p`` holds (expert dim first); entries
    routed elsewhere take no slot. The capacity is the reference's, of
    these N tokens over all E experts. Returns (y2d (N, d), these experts'
    share of the output, and keep)."""
    N, d = x2d.shape
    k = cfg.top_k
    C = capacity(N, cfg)
    order, s_ids, rank, keep = dispatch(ids, n_experts, C, offset)
    s_tok = torch.div(order, k, rounding_mode="floor")
    s_w = w.reshape(-1)[order]

    # --- dispatch: kept entries into their slots, the rest to row E*C
    slot = torch.where(keep, s_ids * C + rank, n_experts * C)
    xbuf = x2d.new_zeros((n_experts * C + 1, d))
    xbuf[slot] = x2d[s_tok]
    xbuf = xbuf[:n_experts * C].view(n_experts, C, d)

    # --- grouped expert FFN -------------------------------------------------
    g = torch.bmm(xbuf, p["wg"])
    u = torch.bmm(xbuf, p["wu"])
    h = F.silu(g.float()).to(x2d.dtype) * u
    ybuf = torch.bmm(h, p["wd"]).view(n_experts * C, d)

    # --- combine: each token's k outputs, added in expert order -------------
    y_tok = ybuf[torch.where(keep, slot, 0)] \
        * (s_w * keep).to(x2d.dtype)[:, None]
    pos = torch.empty_like(order)
    pos[order] = torch.arange(order.numel(), device=x2d.device)
    y_k = y_tok[pos.view(N, k).sort(dim=1).values]          # (N, k, d)
    y2d = y_k[:, 0]
    for j in range(1, k):
        y2d = y2d + y_k[:, j]
    return y2d, keep


def _counts(ids: torch.Tensor, E: int) -> torch.Tensor:
    """Assignments per expert, float32."""
    flat = ids.reshape(-1)
    return torch.zeros((E,), dtype=torch.float32, device=ids.device) \
        .index_add_(0, flat, torch.ones(flat.shape, device=ids.device))


def moe_block(p, x, cfg):
    """x (B,S,d) -> (y (B,S,d), aux dict with load stats). Under an active
    mesh: expert parallelism or the gathered block (module docstring)."""
    mesh = current_mesh()
    if mesh is None:
        return _moe_block_plain(p, x, cfg)
    if os.environ.get("REPRO_MOE_SHARDMAP") == "1" \
            and "model" in mesh.mesh_dim_names \
            and cfg.num_experts % comm.axis_size("model") == 0:
        return _moe_block_ep(p, x, cfg)
    axes = comm.data_axes()
    y, aux = _moe_block_plain(p, comm.gather(x, 0, axes), cfg)
    return comm.block(y, 0, axes), aux


def _moe_block_ep(p, x, cfg):
    """Expert parallelism: tokens over the data axes, E / ep experts on
    each rank of "model"; combine = one all-reduce("model") of the
    (N_local, d) partial outputs."""
    B, S, d = x.shape
    N, E, k = B * S, cfg.num_experts, cfg.top_k
    n_local = E // comm.axis_size("model")
    x2d = x.reshape(N, d)
    ids, w, _ = _route(p, x2d, cfg)
    local = {n: comm.split(p[n], 0, "model") for n in ("wg", "wu", "wd")}
    y, _ = _dispatch_compute_combine(
        local, comm.enter(x2d, "model"), ids, comm.enter(w, "model"), cfg,
        n_local, comm.axis_rank("model") * n_local)
    y = comm.reduce(y, "model").view(B, S, d)
    if cfg.n_shared_experts:
        # the shared expert: d_ff over "model", its own all-reduce
        y = y + mlp_block(p["shared"], x)
    axes = ("model",) + comm.data_axes()
    counts = comm.all_reduce_(_counts(ids, E), axes)
    load = counts / float(comm.axis_size(axes)) * (1.0 / (N * k))
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    return y, {"load": load, "router_entropy": zero, "dropped": zero}


def _moe_block_plain(p, x, cfg):
    """The unsharded block."""
    B, S, d = x.shape
    N, E = B * S, cfg.num_experts
    x2d = x.reshape(N, d)
    ids, w, probs = _route(p, x2d, cfg)
    y2d, keep = _dispatch_compute_combine(p, x2d, ids, w, cfg, E)
    y = y2d.view(B, S, d)

    if cfg.n_shared_experts:
        y = y + mlp_block(p["shared"], x)

    # times the float32 reciprocal, as XLA divides by a constant: the load
    # is then the reference's bit for bit, and so is the bias update's sign
    load = _counts(ids, E) * (1.0 / (N * cfg.top_k))
    aux = {
        "load": load,                 # fraction of assignments per expert
        "router_entropy": -torch.mean(torch.sum(
            probs * torch.log(probs + 1e-9), dim=-1)),
        "dropped": 1.0 - keep.float().mean(),
    }
    return y, aux
