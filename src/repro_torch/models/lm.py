"""Language-model assembly: the dense, MoE (MoE, MLA, MTP) and hybrid
(hymba) families.

``LM(cfg, device=None)`` exposes, as ``repro/models/lm.py`` does:
    init(generator)                    -> params (nested dict of tensors)
    loss(params, batch, remat)         -> (scalar, metrics)  [train]
    prefill(params, batch, max_seq)    -> (cache, last_logits)
    decode(params, cache, batch, pos)  -> (logits, cache)
    init_cache(B, max_seq)             -> cache (zeros)

Layers are stacked per homogeneous *segment* (a leading layer axis on every
leaf, the reference's ``jax.vmap(init_one)`` layout) and run by a Python
loop over the layer index in place of ``lax.scan``. ``decode`` writes each
layer's new cache entries into the stacked cache in place and returns it,
so a step allocates no copy of the cache; ``cache["pos"]`` is a Python int.
In training each layer runs under the ``remat`` policy (``REMAT_POLICIES``)
and takes its parameters as ``unbind`` slices of the stacked leaves, so
the backward stacks each leaf's gradient once. ``init`` fills each stacked
leaf a layer at a time (the full-width MoE models fill most of a card), in
the order a per-layer draw would take.

xLSTM, vision, audio and cross attention are not ported yet (ROADMAP.md)
and raise ``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, Optional

import numpy as np
import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import mla as mla_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.common import (chunked_cross_entropy, dense_init,
                                       dtype_of, embed_init, rmsnorm,
                                       rmsnorm_init)
from repro_torch.models.mlp import init_mlp, mlp_block

_UNPORTED = "not ported yet (ROADMAP.md, queue 1: the other LM families)"

# what a training layer keeps for its backward, as the reference's
# ``REMAT_POLICIES``: everything; only the outputs of matrix products
# without batch dimensions (``dots_with_no_batch_dims_saveable``; the
# attention and scan kernels and the elementwise ops are recomputed); or
# only the layer's input (``nothing_saveable``)
REMAT_POLICIES = ("none", "dots", "full")
_DOTS = {torch.ops.aten.mm.default, torch.ops.aten.addmm.default}


def _save_dots(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(fn, x, policy: str):
    """``fn(x)`` under the remat ``policy``."""
    if policy == "none":
        return fn(x)
    if policy == "full":
        return checkpoint(fn, x, use_reentrant=False)
    return checkpoint(fn, x, use_reentrant=False, context_fn=functools.partial(
        create_selective_checkpoint_contexts, _save_dots))


def _tree_map(fn, *trees):
    t = trees[0]
    if isinstance(t, dict):
        return {k: _tree_map(fn, *(x[k] for x in trees)) for k in t}
    if isinstance(t, (tuple, list)):
        return type(t)(_tree_map(fn, *xs) for xs in zip(*trees))
    return fn(*trees)


def _stack(trees):
    return _tree_map(lambda *xs: torch.stack(xs), *trees)


def _init_stacked(n: int, draw):
    """``_stack([draw() for _ in range(n)])`` without holding the layers
    twice: the stacked leaves are allocated after the first draw and each
    layer is copied into its slot as it is drawn (the same draws, in the
    same order)."""
    first = draw()
    if n == 1:
        return _tree_map(lambda a: a.unsqueeze(0), first)
    out = _tree_map(lambda a: a.new_empty((n,) + tuple(a.shape)), first)
    for i in range(n):
        layer = first if i == 0 else draw()
        _tree_map(lambda o, a: o[i].copy_(a), out, layer)
        first = layer = None
    return out


def _layer(tree, i: int):
    """Layer ``i``'s slice of a stacked tree: views, no copies."""
    return _tree_map(lambda a: a[i], tree)


def _unstack(tree):
    """The per-layer trees of a stacked parameter tree (nested dicts), as
    ``unbind`` views."""
    if isinstance(tree, dict):
        per_key = {k: _unstack(v) for k, v in tree.items()}
        n = len(next(iter(per_key.values())))
        return [{k: v[i] for k, v in per_key.items()} for i in range(n)]
    return list(tree.unbind(0))


def _pad_seq(t: torch.Tensor, total: int) -> torch.Tensor:
    """A stacked prefill cache leaf (Lseg, B, S', ...) in a zero cache of
    ``total`` positions."""
    out = t.new_zeros((t.shape[0], t.shape[1], total) + tuple(t.shape[3:]))
    out[:, :, :t.shape[2]] = t
    return out


def _store(dst, src) -> None:
    """Write a layer's new cache entry into its slot of the stacked cache,
    unless it already is that slot (updated in place)."""
    if src.data_ptr() != dst.data_ptr():
        dst.copy_(src)


# ===========================================================================
# per-layer init / apply
# ===========================================================================


def _init_layer(gen, cfg, dtype, device, *, kind: str):
    """kind: dense | moe | hymba"""
    d = cfg.d_model
    init_attn = mla_mod.init_mla if cfg.mla else attn.init_attn
    p: Dict[str, Any] = {"ln1": rmsnorm_init(d, device),
                         "ln2": rmsnorm_init(d, device),
                         "attn": init_attn(gen, cfg, dtype, device)}
    if kind == "moe":
        p["moe"] = moe_mod.init_moe(gen, cfg, dtype, device)
    else:
        p["mlp"] = init_mlp(gen, d, cfg.d_ff, cfg.mlp_type, dtype, device)
    if kind == "hymba":
        p["ssm"] = ssm_mod.init_ssm(gen, cfg, dtype, device)
        p["mix_a"] = torch.full((d,), 0.5, dtype=torch.float32, device=device)
        p["mix_s"] = torch.full((d,), 0.5, dtype=torch.float32, device=device)
        p["norm_a"] = rmsnorm_init(d, device)
        p["norm_s"] = rmsnorm_init(d, device)
    return p


def _mix(p, a, s):
    """Hymba's fusion of the attention and SSM heads."""
    return (rmsnorm(a, p["norm_a"]) * p["mix_a"].to(a.dtype)
            + rmsnorm(s, p["norm_s"]) * p["mix_s"].to(a.dtype))


def _mixer(p, x, cfg, positions, *, kind, window, sink, cache=None, pos=None,
           ssm_state=None):
    """Attention(+SSM) sub-block. Returns (out, new_cache, new_ssm_state)."""
    if cache is None:  # prefill / train
        if cfg.mla:
            a, kv = mla_mod.mla_block(p["attn"], x, cfg, positions)
        else:
            a, kv = attn.attn_block(p["attn"], x, cfg, positions,
                                    window=window, sink=sink)
        if kind == "hymba":
            s, ssm_state = ssm_mod.ssm_block(p["ssm"], x, cfg)
            a = _mix(p, a, s)
        return a, kv, ssm_state
    if cfg.mla:
        a, cache = mla_mod.mla_decode_block(p["attn"], x, cfg, cache[0],
                                            cache[1], pos)
    else:
        a, cache = attn.decode_attn_block(p["attn"], x, cfg, cache[0],
                                          cache[1], pos, window=window)
    if kind == "hymba":
        s, ssm_state = ssm_mod.ssm_decode_block(p["ssm"], x, cfg, ssm_state[0],
                                                ssm_state[1])
        a = _mix(p, a, s)
    return a, cache, ssm_state


def _ffn(p, h, cfg, kind):
    """The feed-forward sub-block: (out, MoE aux dict or None)."""
    if kind == "moe":
        return moe_mod.moe_block(p["moe"], h, cfg)
    return mlp_block(p["mlp"], h), None


def _layer_apply(p, x, cfg, positions, *, kind, window, sink):
    """Train/prefill layer. Returns (x, cache_entry, aux)."""
    a, kv, ssm_state = _mixer(p, rmsnorm(x, p["ln1"]), cfg, positions,
                              kind=kind, window=window, sink=sink)
    x = x + a
    m, aux = _ffn(p, rmsnorm(x, p["ln2"]), cfg, kind)
    return x + m, ((kv, ssm_state) if kind == "hymba" else kv), aux


def _layer_decode(p, x, cfg, cache, pos, *, kind, window):
    """Decode layer against full KV caches. Returns (x, new_cache)."""
    kv = cache[0] if kind == "hymba" else cache
    ssm_state = cache[1] if kind == "hymba" else None
    a, kv, ssm_state = _mixer(p, rmsnorm(x, p["ln1"]), cfg, None, kind=kind,
                              window=window, sink=0, cache=kv, pos=pos,
                              ssm_state=ssm_state)
    x = x + a
    m, _ = _ffn(p, rmsnorm(x, p["ln2"]), cfg, kind)
    return x + m, ((kv, ssm_state) if kind == "hymba" else kv)


def _ring_layer_decode(p, x, cfg, cache, pos):
    """Hymba SWA layer decode with ring cache + meta prefix + parallel SSM."""
    kvc, ssm_state = cache
    h = rmsnorm(x, p["ln1"])
    a, kvc = _ring_attend(p["attn"], h, cfg, kvc, pos)
    s, ssm_state = ssm_mod.ssm_decode_block(p["ssm"], h, cfg, ssm_state[0],
                                            ssm_state[1])
    x = x + _mix(p, a, s)
    m = mlp_block(p["mlp"], rmsnorm(x, p["ln2"]))
    return x + m, (kvc, ssm_state)


def _ring_attend(p, x, cfg, kvc, pos: int):
    """Attention over meta prefix + ring window cache. Writes the token's
    k, v and position into its ring slot in place; returns (out, kvc)."""
    W, meta = cfg.window, cfg.meta_tokens or 0
    positions = torch.full((1,), pos, dtype=torch.int64, device=x.device)
    q, k_new, v_new = attn._qkv(p, x, cfg, positions)
    slot = (pos - meta) % W
    kvc["ring_k"][:, slot] = k_new[:, 0].to(kvc["ring_k"].dtype)
    kvc["ring_v"][:, slot] = v_new[:, 0].to(kvc["ring_v"].dtype)
    kvc["ring_pos"][slot] = pos
    k_all = torch.cat([kvc["meta_k"], kvc["ring_k"]], dim=1)
    v_all = torch.cat([kvc["meta_v"], kvc["ring_v"]], dim=1)
    pos_all = torch.cat([torch.arange(meta, device=x.device,
                                      dtype=kvc["ring_pos"].dtype),
                         kvc["ring_pos"]])
    is_meta = torch.arange(meta + W, device=x.device) < meta
    valid = (pos_all >= 0) & (pos_all <= pos) & ((pos - pos_all < W) | is_meta)
    o = attn.attend_cache(q, k_all, v_all, valid)
    return attn._out(o.to(x.dtype), p["wo"]), kvc


# ===========================================================================
# segment plan
# ===========================================================================


@dataclasses.dataclass(frozen=True)
class Segment:
    name: str
    kind: str          # dense | moe | hymba
    layers: tuple      # absolute layer indices
    window: Any        # None = full attention


def build_plan(cfg):
    L = cfg.num_layers
    if cfg.family == "dense":
        return [Segment("blocks", "dense", tuple(range(L)), None)]
    if cfg.family == "moe":
        nd = cfg.first_dense_layers
        segs = [Segment("dense", "dense", tuple(range(nd)), None)] if nd \
            else []
        return segs + [Segment("moe", "moe", tuple(range(nd, L)), None)]
    if cfg.family != "hybrid":
        raise NotImplementedError(f"family {cfg.family!r} is {_UNPORTED}")
    segs = []
    full = set(cfg.full_attn_every)
    i = si = 0
    while i < L:
        if i in full:
            segs.append(Segment(f"full{i}", "hymba", (i,), None))
            i += 1
        else:
            j = i
            while j < L and j not in full:
                j += 1
            segs.append(Segment(f"swa{si}", "hymba", tuple(range(i, j)),
                                cfg.window))
            si += 1
            i = j
    return segs


# ===========================================================================
# LM
# ===========================================================================


class LM:
    def __init__(self, cfg, device: DeviceLike = None):
        unported = [f for f in ("vision", "cross_attn", "audio_codebooks")
                    if getattr(cfg, f)]
        if unported:
            raise NotImplementedError(f"{cfg.name}: {unported} {_UNPORTED}")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.plan = build_plan(cfg)
        self.dtype = dtype_of(cfg)

    # ------------------------------------------------------------------ init
    def init(self, generator: Optional[torch.Generator] = None):
        """Random parameters drawn from ``generator`` (a ``torch.Generator``
        on this LM's device; None draws from the device's default one). A
        segment's stacked leaves are filled a layer at a time, so the
        layers are never held twice."""
        cfg, dtype, dev, g = self.cfg, self.dtype, self.device, generator
        d = cfg.d_model
        params: Dict[str, Any] = {
            "embed": embed_init(g, (cfg.vocab_size, d), dtype, dev)}
        if not cfg.tie_embeddings:
            params["head"] = dense_init(g, (d, cfg.vocab_size), dtype, dev)
        if cfg.meta_tokens:
            params["meta"] = embed_init(g, (cfg.meta_tokens, d), dtype, dev)
        for seg in self.plan:
            params[seg.name] = _init_stacked(
                len(seg.layers),
                lambda seg=seg: _init_layer(g, cfg, dtype, dev, kind=seg.kind))
        params["ln_f"] = rmsnorm_init(d, dev)
        if cfg.mtp:
            params["mtp"] = {
                "proj": dense_init(g, (2 * d, d), dtype, dev),
                "ln_h": rmsnorm_init(d, dev),
                "ln_e": rmsnorm_init(d, dev),
                "layer": _init_layer(g, cfg, dtype, dev, kind="moe"),
                "ln_f": rmsnorm_init(d, dev),
            }
        return params

    # ------------------------------------------------------------------ loss
    def loss(self, params, batch, remat: str = "full"):
        """Next-token cross entropy of ``batch["tokens"]`` (B, S_text): the
        meta tokens are prepended, every layer runs under ``remat``, and the
        text positions but the last predict the next token. With MoE layers
        the loss adds the reference's balance penalty (1e-3 E mean_l
        sum_e load^2, no gradient: the load counts selections) and the
        metrics carry ``moe_load`` (L_moe, E) and ``moe_dropped``; with MTP
        it adds 0.3 x the loss of predicting token t+2. Returns (loss,
        metrics)."""
        if remat not in REMAT_POLICIES:
            raise ValueError(f"remat must be one of {REMAT_POLICIES}, got "
                             f"{remat!r}")
        cfg = self.cfg
        x = self._embed_inputs(params, batch)
        positions = torch.arange(x.shape[1], device=self.device)
        x, auxes = self._run_train(params, x, positions, remat)
        x = rmsnorm(x, params["ln_f"])
        h = x[:, cfg.meta_tokens or 0:]
        loss = chunked_cross_entropy(h[:, :-1], self._head(params),
                                     self._tokens(batch)[:, 1:])
        metrics: Dict[str, Any] = {}
        if auxes:
            load = torch.stack([a["load"] for a in auxes])      # (Lmoe, E)
            metrics["moe_load"] = load
            metrics["moe_dropped"] = torch.stack(
                [a["dropped"] for a in auxes]).mean()
            loss = loss + 1e-3 * cfg.num_experts * torch.mean(
                torch.sum(load * load, dim=-1))
        if cfg.mtp:
            loss = loss + 0.3 * self._mtp_loss(params, x, batch, positions)
        metrics["loss"] = loss
        return loss, metrics

    def _mtp_loss(self, params, h, batch, positions):
        """DeepSeek multi-token prediction: one extra MoE layer over the
        final hidden state and the next token's embedding predicts t+2."""
        mp = params["mtp"]
        toks = self._tokens(batch)
        emb_next = params["embed"][toks[:, 1:]]                 # (B,S-1,d)
        hh = torch.cat([rmsnorm(h[:, :-1], mp["ln_h"]),
                        rmsnorm(emb_next, mp["ln_e"])], dim=-1)
        x = _layer_apply(mp["layer"], hh @ mp["proj"], self.cfg,
                         positions[:-1], kind="moe", window=None, sink=0)[0]
        x = rmsnorm(x, mp["ln_f"])
        return chunked_cross_entropy(x[:, :-1], self._head(params),
                                     toks[:, 2:])

    def _run_train(self, params, x, positions, remat: str):
        """Every layer, its caches dropped, under the ``remat`` policy.
        Returns (x, the MoE layers' aux dicts in layer order)."""
        cfg = self.cfg
        auxes = []
        for seg in self.plan:
            sink = cfg.meta_tokens if seg.window is not None else 0
            for lp in _unstack(params[seg.name]):
                def layer(h, lp=lp, seg=seg, sink=sink):
                    out, _, aux = _layer_apply(lp, h, cfg, positions,
                                               kind=seg.kind,
                                               window=seg.window, sink=sink)
                    return out, aux
                x, aux = _remat(layer, x, remat)
                if aux is not None:
                    auxes.append(aux)
        return x, auxes

    # -------------------------------------------------------------- embedding
    def _tokens(self, batch) -> torch.Tensor:
        toks = batch["tokens"]
        if not isinstance(toks, torch.Tensor):
            toks = torch.from_numpy(np.asarray(toks))
        return toks.to(self.device, torch.long)

    def _embed_inputs(self, params, batch):
        """(B, S_text) tokens -> x (B, meta + S_text, d)."""
        x = params["embed"][self._tokens(batch)]
        if self.cfg.meta_tokens:
            meta = params["meta"][None].expand(x.shape[0], -1, -1)
            x = torch.cat([meta, x], dim=1)
        return x

    def _head(self, params):
        return params["embed"].T if self.cfg.tie_embeddings else params["head"]

    def _run_segments(self, params, x, positions):
        """Prefill through every layer. Returns (x, per-segment caches with
        a leading layer axis)."""
        cfg = self.cfg
        caches: Dict[str, Any] = {}
        for seg in self.plan:
            sink = cfg.meta_tokens if seg.window is not None else 0
            entries = []
            for i in range(len(seg.layers)):
                x, cache, _ = _layer_apply(_layer(params[seg.name], i), x, cfg,
                                           positions, kind=seg.kind,
                                           window=seg.window, sink=sink)
                entries.append(cache)
            caches[seg.name] = _stack(entries)
        return x, caches

    # --------------------------------------------------------------- prefill
    def prefill(self, params, batch, max_seq=None):
        """Run the full prompt; build decode caches. Returns (cache, logits)."""
        x = self._embed_inputs(params, batch)
        S = x.shape[1]
        positions = torch.arange(S, device=self.device)
        x, caches = self._run_segments(params, x, positions)
        x = rmsnorm(x, params["ln_f"])
        logits = x[:, -1] @ self._head(params)
        return self._layout_cache(caches, S, max_seq or (2 * S)), logits

    def _layout_cache(self, caches, S, max_seq):
        """Prefill per-layer outputs -> fixed-size decode caches."""
        cfg = self.cfg
        out: Dict[str, Any] = {"pos": S}   # S includes the meta prefix
        total = max_seq + (cfg.meta_tokens or 0)
        for seg in self.plan:
            kv, ssm_state = caches[seg.name] if seg.kind == "hymba" else (
                caches[seg.name], None)
            if seg.window is not None:
                out[seg.name] = self._ring_from_prefill(*kv)
            else:   # (k, v) (Lseg,B,S',K,hd), or MLA's (ckv, kr) (Lseg,B,S',r)
                out[seg.name] = tuple(_pad_seq(t, total) for t in kv)
            if ssm_state is not None:
                out[seg.name] = (out[seg.name], ssm_state)
        return out

    def _ring_from_prefill(self, k, v):
        """Ring (sliding-window) cache: keep last W positions + meta prefix."""
        cfg = self.cfg
        W = cfg.window
        Ls, B, Sp, K, hd = k.shape
        meta = cfg.meta_tokens or 0
        St = Sp - meta
        ring_k = torch.zeros((Ls, B, W, K, hd), dtype=k.dtype, device=k.device)
        ring_v = torch.zeros_like(ring_k)
        ring_pos = torch.full((W,), -1, dtype=torch.int32, device=k.device)
        if St >= W:
            tail_pos = torch.arange(St - W, St, device=k.device) + meta
            slots = torch.remainder(tail_pos - meta, W)
            ring_k[:, :, slots] = k[:, :, meta:][:, :, -W:]
            ring_v[:, :, slots] = v[:, :, meta:][:, :, -W:]
        else:
            tail_pos = torch.arange(St, device=k.device) + meta
            slots = torch.arange(St, device=k.device)
            ring_k[:, :, :St] = k[:, :, meta:]
            ring_v[:, :, :St] = v[:, :, meta:]
        ring_pos[slots] = tail_pos.to(torch.int32)
        return {"meta_k": k[:, :, :meta], "meta_v": v[:, :, :meta],
                "ring_k": ring_k, "ring_v": ring_v,
                "ring_pos": ring_pos.expand(Ls, W).contiguous()}

    # ---------------------------------------------------------------- decode
    def init_cache(self, B, max_seq):
        """Zero-initialized decode cache."""
        cfg, dtype, dev = self.cfg, self.dtype, self.device
        meta = cfg.meta_tokens or 0
        total = max_seq + meta
        K, hd = cfg.num_kv_heads, cfg.head_dim
        di = cfg.d_model * cfg.ssm_expand
        cache: Dict[str, Any] = {"pos": total - 1}
        for seg in self.plan:
            Ls = len(seg.layers)

            def zeros(*shape, dt=dtype):
                return torch.zeros(shape, dtype=dt, device=dev)
            if cfg.mla:
                kv = (zeros(Ls, B, total, cfg.kv_lora_rank),
                      zeros(Ls, B, total, cfg.qk_rope_dim))
            elif seg.window is not None:
                kv = {"meta_k": zeros(Ls, B, meta, K, hd),
                      "meta_v": zeros(Ls, B, meta, K, hd),
                      "ring_k": zeros(Ls, B, cfg.window, K, hd),
                      "ring_v": zeros(Ls, B, cfg.window, K, hd),
                      "ring_pos": torch.full((Ls, cfg.window), -1,
                                             dtype=torch.int32, device=dev)}
            else:
                kv = (zeros(Ls, B, total, K, hd), zeros(Ls, B, total, K, hd))
            if seg.kind == "hymba":
                kv = (kv, (zeros(Ls, B, di, cfg.ssm_state, dt=torch.float32),
                           zeros(Ls, B, cfg.conv_width - 1, di)))
            cache[seg.name] = kv
        return cache

    def decode(self, params, cache, batch, pos: Optional[int] = None):
        """One decode step. batch: {'tokens': (B,)}. Updates ``cache`` in
        place; returns (logits, cache) with ``cache["pos"]`` advanced."""
        cfg = self.cfg
        pos = cache["pos"] if pos is None else int(pos)
        x = params["embed"][self._tokens(batch)][:, None, :]       # (B,1,d)
        for seg in self.plan:
            stacked = cache[seg.name]
            for i in range(len(seg.layers)):
                lp, old = _layer(params[seg.name], i), _layer(stacked, i)
                if seg.window is not None:
                    x, new = _ring_layer_decode(lp, x, cfg, old, pos)
                else:
                    x, new = _layer_decode(lp, x, cfg, old, pos,
                                           kind=seg.kind, window=None)
                _tree_map(_store, old, new)
        x = rmsnorm(x, params["ln_f"])[:, 0]                          # (B,d)
        cache["pos"] = pos + 1
        return x @ self._head(params), cache
