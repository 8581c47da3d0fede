"""Language-model assembly for every registered architecture: the dense,
MoE (MoE, MLA, MTP), hybrid (hymba), xLSTM, vision (patches through a
projector in front of the text) and audio (summed codebook embeddings,
per-codebook heads, cross attention over a condition) families.

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
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import mla as mla_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models import xlstm as xlstm_mod
from repro_torch.models.common import (chunked_cross_entropy, dense_init,
                                       dtype_of, embed_init, rmsnorm,
                                       rmsnorm_init)
from repro_torch.models.mlp import init_mlp, mlp_block

# the xLSTM layer kinds: (init, block, decode) of their core
_XLSTM = {"mlstm": (xlstm_mod.init_mlstm, xlstm_mod.mlstm_block,
                    xlstm_mod.mlstm_decode),
          "slstm": (xlstm_mod.init_slstm, xlstm_mod.slstm_block,
                    xlstm_mod.slstm_decode)}

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
    """kind: dense | moe | hymba | mlstm | slstm"""
    d = cfg.d_model
    if kind in _XLSTM:
        return {"ln": rmsnorm_init(d, device),
                "core": _XLSTM[kind][0](gen, cfg, dtype, device)}
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
    if cfg.cross_attn:
        p["ln_x"] = rmsnorm_init(d, device)
        p["cross"] = attn.init_cross_attn(gen, cfg, dtype, device)
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


def _layer_apply(p, x, cfg, positions, *, kind, window, sink, cond=None):
    """Train/prefill layer; ``cond`` (B,T,d), the projected condition of a
    cross-attention model. Returns (x, cache_entry, aux)."""
    if kind in _XLSTM:
        h, state = _XLSTM[kind][1](p["core"], rmsnorm(x, p["ln"]), cfg)
        return x + h, state, None
    a, kv, ssm_state = _mixer(p, rmsnorm(x, p["ln1"]), cfg, positions,
                              kind=kind, window=window, sink=sink)
    x = x + a
    if cond is not None:
        x = x + attn.cross_attn_block(p["cross"], rmsnorm(x, p["ln_x"]), cond)
    m, aux = _ffn(p, rmsnorm(x, p["ln2"]), cfg, kind)
    return x + m, ((kv, ssm_state) if kind == "hymba" else kv), aux


def _layer_decode(p, x, cfg, cache, pos, *, kind, window, cond=None):
    """Decode layer against full KV caches (an xLSTM layer: its states).
    Returns (x, new_cache)."""
    if kind in _XLSTM:
        h, state = _XLSTM[kind][2](p["core"], rmsnorm(x, p["ln"]), cfg, cache)
        return x + h, state
    kv = cache[0] if kind == "hymba" else cache
    ssm_state = cache[1] if kind == "hymba" else None
    a, kv, ssm_state = _mixer(p, rmsnorm(x, p["ln1"]), cfg, None, kind=kind,
                              window=window, sink=0, cache=kv, pos=pos,
                              ssm_state=ssm_state)
    x = x + a
    if cond is not None:
        x = x + attn.cross_attn_block(p["cross"], rmsnorm(x, p["ln_x"]), cond)
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
    kind: str          # dense | moe | hymba | mlstm | slstm
    layers: tuple      # absolute layer indices
    window: Any        # None = full attention


def _runs(L: int, single, one_name: str, one_kind: str, run_name: str,
          run_kind: str, window):
    """Layers in ``single`` each a segment of their own (``<one_name><i>``);
    the runs between them ``<run_name><k>``, k counting the runs."""
    segs = []
    i = k = 0
    while i < L:
        if i in single:
            segs.append(Segment(f"{one_name}{i}", one_kind, (i,), None))
            i += 1
        else:
            j = i
            while j < L and j not in single:
                j += 1
            segs.append(Segment(f"{run_name}{k}", run_kind,
                                tuple(range(i, j)), window))
            k += 1
            i = j
    return segs


def build_plan(cfg):
    L = cfg.num_layers
    if cfg.family in ("dense", "vlm", "audio"):
        return [Segment("blocks", "dense", tuple(range(L)), None)]
    if cfg.family == "moe":
        nd = cfg.first_dense_layers
        segs = [Segment("dense", "dense", tuple(range(nd)), None)] if nd \
            else []
        return segs + [Segment("moe", "moe", tuple(range(nd, L)), None)]
    if cfg.family == "hybrid":
        return _runs(L, set(cfg.full_attn_every), "full", "hymba", "swa",
                     "hymba", cfg.window)
    if cfg.family == "ssm":
        return _runs(L, set(cfg.slstm_layers), "slstm", "slstm", "mlstm",
                     "mlstm", None)
    raise ValueError(cfg.family)


# ===========================================================================
# LM
# ===========================================================================


class LM:
    def __init__(self, cfg, device: DeviceLike = None):
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
        d, V, nq = cfg.d_model, cfg.vocab_size, cfg.audio_codebooks
        params: Dict[str, Any] = {}
        if nq:
            params["embed"] = embed_init(g, (nq, V, d), dtype, dev)
            params["heads"] = dense_init(g, (nq, d, V), dtype, dev)
        else:
            params["embed"] = embed_init(g, (V, d), dtype, dev)
            if not cfg.tie_embeddings:
                params["head"] = dense_init(g, (d, V), dtype, dev)
        if cfg.vision:
            params["vis_proj"] = {
                "w1": dense_init(g, (cfg.vision_dim, d), dtype, dev),
                "w2": dense_init(g, (d, d), dtype, dev)}
        if cfg.cross_attn:
            params["cond_proj"] = dense_init(g, (cfg.cond_dim, d), dtype, dev)
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
        meta tokens (and a vision model's projected ``patches``) are
        prepended, every layer runs under ``remat``, and the text positions
        but the last predict the next token. An audio model's loss is the
        mean over its codebooks of the cross entropy of ``batch["codes"]``
        (B, nq, S), each through its own head, with ``batch["cond"]``
        attended by every layer. With MoE layers
        the loss adds the reference's balance penalty (1e-3 E mean_l
        sum_e load^2, no gradient: the load counts selections) and the
        metrics carry ``moe_load`` (L_moe, E) and ``moe_dropped``; with MTP
        it adds 0.3 x the loss of predicting token t+2. Returns (loss,
        metrics)."""
        if remat not in REMAT_POLICIES:
            raise ValueError(f"remat must be one of {REMAT_POLICIES}, got "
                             f"{remat!r}")
        cfg = self.cfg
        x, cond = self._embed_inputs(params, batch)
        positions = torch.arange(x.shape[1], device=self.device)
        x, auxes = self._run_train(params, x, positions, remat, cond)
        x = rmsnorm(x, params["ln_f"])
        if cfg.audio_codebooks:
            codes = self._tokens(batch, "codes")                  # (B, nq, S)
            loss = sum(chunked_cross_entropy(x[:, :-1], params["heads"][k],
                                             codes[:, k, 1:])
                       for k in range(cfg.audio_codebooks)
                       ) / cfg.audio_codebooks
        else:
            h = x[:, self._prefix():]
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

    def _run_train(self, params, x, positions, remat: str, cond=None):
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
                                               window=seg.window, sink=sink,
                                               cond=cond)
                    return out, aux
                x, aux = _remat(layer, x, remat)
                if aux is not None:
                    auxes.append(aux)
        return x, auxes

    # -------------------------------------------------------------- embedding
    def _tokens(self, batch, key: str = "tokens") -> torch.Tensor:
        t = batch[key]
        if not isinstance(t, torch.Tensor):
            t = torch.from_numpy(np.asarray(t))
        return t.to(self.device, torch.long)

    def _floats(self, batch, key: str) -> torch.Tensor:
        """``batch[key]`` (float32) cast to the model dtype, on the device."""
        t = batch[key]
        if not isinstance(t, torch.Tensor):
            t = torch.from_numpy(np.asarray(t))
        return t.to(self.device).to(self.dtype)

    def _prefix(self) -> int:
        """Positions in front of the text: the patches and the meta tokens."""
        cfg = self.cfg
        return (cfg.num_patches if cfg.vision else 0) + (cfg.meta_tokens or 0)

    def _embed_codes(self, params, codes):
        """codes (B, nq, ...) -> the codebooks' embeddings summed in the
        reference's order and dtype (``sum``: 0 + e_0 + e_1 + ...)."""
        return sum(params["embed"][k][codes[:, k]]
                   for k in range(self.cfg.audio_codebooks))

    def _cond(self, params, batch):
        """The condition (B, T, cond_dim) projected to (B, T, d)."""
        return self._floats(batch, "cond") @ params["cond_proj"]

    def _embed_inputs(self, params, batch):
        """Returns (x (B, S, d), cond (B, T, d) or None). Text: x is the
        meta tokens, a vision model's projected patches (``w1``, tanh GELU
        in float32, ``w2``), then the token embeddings; audio: the summed
        codebook embeddings of ``codes`` (B, nq, S), with ``cond``."""
        cfg = self.cfg
        if cfg.audio_codebooks:
            return (self._embed_codes(params, self._tokens(batch, "codes")),
                    self._cond(params, batch))
        x = params["embed"][self._tokens(batch)]
        if cfg.vision:
            pv = params["vis_proj"]
            h = self._floats(batch, "patches") @ pv["w1"]
            h = F.gelu(h.float(), approximate="tanh").to(self.dtype)
            x = torch.cat([h @ pv["w2"], x], dim=1)
        if cfg.meta_tokens:
            meta = params["meta"][None].expand(x.shape[0], -1, -1)
            x = torch.cat([meta, x], dim=1)
        return x, None

    def _head(self, params):
        return params["embed"].T if self.cfg.tie_embeddings else params["head"]

    def _logits(self, params, h):
        """h (B, d) -> logits (B, V), or (B, nq, V) through an audio model's
        per-codebook heads."""
        if self.cfg.audio_codebooks:
            return torch.stack([h @ params["heads"][k]
                                for k in range(self.cfg.audio_codebooks)],
                               dim=1)
        return h @ self._head(params)

    def _run_segments(self, params, x, positions, cond=None):
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
                                           window=seg.window, sink=sink,
                                           cond=cond)
                entries.append(cache)
            caches[seg.name] = _stack(entries)
        return x, caches

    # --------------------------------------------------------------- prefill
    def prefill(self, params, batch, max_seq=None):
        """Run the full prompt; build decode caches. Returns (cache, logits)."""
        x, cond = self._embed_inputs(params, batch)
        S = x.shape[1]
        positions = torch.arange(S, device=self.device)
        x, caches = self._run_segments(params, x, positions, cond)
        x = rmsnorm(x, params["ln_f"])
        logits = self._logits(params, x[:, -1])
        return self._layout_cache(caches, S, max_seq or (2 * S)), logits

    def _layout_cache(self, caches, S, max_seq):
        """Prefill per-layer outputs -> fixed-size decode caches."""
        out: Dict[str, Any] = {"pos": S}   # S includes the prefix
        total = max_seq + self._prefix()
        for seg in self.plan:
            if seg.kind in _XLSTM:             # the states pass through
                out[seg.name] = caches[seg.name]
                continue
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
        """Zero-initialized decode cache; an xLSTM layer's states are zero
        with the stabilizer m at its start (-1e30)."""
        cfg, dtype, dev = self.cfg, self.dtype, self.device
        meta = cfg.meta_tokens or 0
        total = max_seq + self._prefix()
        H, K, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        di = cfg.d_model * cfg.ssm_expand
        cache: Dict[str, Any] = {"pos": total - 1}
        for seg in self.plan:
            Ls = len(seg.layers)

            def zeros(*shape, dt=dtype):
                return torch.zeros(shape, dtype=dt, device=dev)
            if seg.kind in _XLSTM:
                f32 = torch.float32
                m = torch.full((Ls, B, H), xlstm_mod.M_INIT, dtype=f32,
                               device=dev)
                if seg.kind == "mlstm":
                    dh = 2 * cfg.d_model // H
                    cache[seg.name] = (zeros(Ls, B, H, dh, dh, dt=f32),
                                       zeros(Ls, B, H, dh, dt=f32), m)
                else:
                    dh = cfg.d_model // H
                    cache[seg.name] = (zeros(Ls, B, H, dh, dt=f32),
                                       zeros(Ls, B, H, dh, dt=f32), m,
                                       zeros(Ls, B, H, dh, dt=f32))
                continue
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
        """One decode step. batch: {'tokens': (B,)}, or an audio model's
        {'tokens': (B, nq) codes, 'cond': (B, T, cond_dim)} (the condition
        projected every step, as the reference does). Updates ``cache`` in
        place; returns (logits (B, V) or (B, nq, V), cache) with
        ``cache["pos"]`` advanced."""
        cfg = self.cfg
        pos = cache["pos"] if pos is None else int(pos)
        if cfg.audio_codebooks:
            x = self._embed_codes(params, self._tokens(batch))[:, None, :]
            cond = self._cond(params, batch)
        else:
            x = params["embed"][self._tokens(batch)][:, None, :]   # (B,1,d)
            cond = None
        for seg in self.plan:
            stacked = cache[seg.name]
            for i in range(len(seg.layers)):
                lp, old = _layer(params[seg.name], i), _layer(stacked, i)
                if seg.window is not None:
                    x, new = _ring_layer_decode(lp, x, cfg, old, pos)
                else:
                    x, new = _layer_decode(lp, x, cfg, old, pos,
                                           kind=seg.kind, window=None,
                                           cond=cond)
                _tree_map(_store, old, new)
        x = rmsnorm(x, params["ln_f"])[:, 0]                          # (B,d)
        cache["pos"] = pos + 1
        return self._logits(params, x), cache
