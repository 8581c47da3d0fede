"""Flash-attention wrapper: ``flash_attention(q, k, v, causal, *, window,
sink, round_p)``, differentiable.

The value head dim may differ from the query/key one (MLA: 192 and 128).
The forward and backward kernels are instantiated for the (D, Dv) pairs of
``HEAD_DIM_PAIRS``; a query/key dim between two of them is padded with
zeros up to the next one with the same Dv (the scores do not change) and
scaled by 1/sqrt of its unpadded width, as the reference scales it; the
backward slices the padded columns' gradients off dq and dk.

On CUDA tensors the forward launches the hand-written kernel of
``kernels/csrc/flash_attention.cu`` (built on first use by
``kernels.build``), counted in ``flash_attention.launches`` and the
``kernels.dispatch.flash_attention.cuda`` counter; which of the library's
kernels a launch runs is ``forward_kernel``'s answer (bf16 at
``WGMMA_FWD_PAIRS``: the wgmma kernel, also counted in
``flash_attention.wg_launches``). When autograd will need
the gradient it runs as ``_FlashAttention`` (a ``torch.autograd.Function``):
the forward also writes each row's log-sum-exp, and the backward launches
``kernels/csrc/flash_attention_bwd.cu``, counted in
``flash_attention_bwd.launches`` and ``kernels.dispatch.flash_attention_bwd.
cuda``; which kernel pair a backward launch runs is ``backward_kernel``'s
answer (bf16 at D = 64: ``dkdv_kernel_wg`` / ``dq_kernel_wg``, one wgmma
warpgroup a block; at ``WGMMA_PAIRS``, (96, 96), (128, 128) and (192,
128): ``dkdv_kernel_wg2`` / ``dq_kernel_wg2``, two, their rows 64-column
slabs in the 128-byte swizzle, at D = 96 three 32-column slabs in the
64-byte swizzle; the reduced configs' bf16 pairs (16, 16), (32, 32) and
(32, 16) ``dkdv_kernel_tc`` / ``dq_kernel_tc`` on mma.sync; float32 the
``_f32`` pair), the wgmma ones also counted in
``flash_attention_bwd.wg_launches``.
Neither falls back. On CPU tensors it runs the plain version,
``kernels.ref.attention_ref`` (counted in
``kernels.dispatch.flash_attention.plain``), under plain autograd; on meta
tensors inside ``kernels.meta.shapes_only()`` (the dry run) it returns the
output's shape. Under the sanitizer (``analysis.sanitize.wrap``) the
kernels' outputs are checked for a NaN their inputs did not hold.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch import obs
from repro_torch.analysis import sanitize
from repro_torch.kernels import build, meta
from repro_torch.kernels.ref import attention_ref

HEAD_DIMS = (16, 32, 64, 96, 128)   # the D the kernels take with Dv = D
# the (D, Dv) the forward kernel is instantiated for: Dv = D, MLA's (192,
# 128) and the reduced MLA's, whose query/key dim 24 pads to 32
HEAD_DIM_PAIRS = tuple((d, d) for d in HEAD_DIMS) + ((32, 16), (192, 128))
# the (D, Dv) whose bf16 forward runs on wgmma (flash_kernel_wg: two
# consumer warpgroups and a producer a block); the other bf16 pairs run
# flash_kernel_tc (mma.sync), float32 flash_kernel_f32
WGMMA_FWD_PAIRS = ((64, 64), (96, 96), (128, 128), (192, 128))
# the (D, Dv) whose bf16 backward runs on two wgmma warpgroups a block
# (dkdv_kernel_wg2, dq_kernel_wg2; csrc/flash_attention_bwd.cu's wg2_pair)
WGMMA_PAIRS = ((96, 96), (128, 128), (192, 128))
# the (D, Dv) whose bf16 backward runs on one wgmma warpgroup a block
# (dkdv_kernel_wg, dq_kernel_wg); the others not in WGMMA_PAIRS on
# mma.sync (dkdv_kernel_tc, dq_kernel_tc)
WGMMA_BWD_ONE = ((64, 64),)
# the dK/dV blocks a two-warpgroup backward launch needs before a block sums
# the G query heads of its kv head (csrc/flash_attention_bwd.cu's
# kSumHeadsBlocks)
SUM_HEADS_BLOCKS = 512
_MAX_GRID_Y = 65535                 # B * H blocks along the grid's y axis
_MAX_WG2_Q_TILES = 1 << 16          # dkdv_kernel_wg2's items: g << 16 | tile

_C_CUDA = obs.counter("kernels.dispatch.flash_attention.cuda")
_C_PLAIN = obs.counter("kernels.dispatch.flash_attention.plain")
_C_BWD = obs.counter("kernels.dispatch.flash_attention_bwd.cuda")


def _check(q, k, v, causal, window, sink) -> None:
    if q.dtype not in (torch.float32, torch.bfloat16) or not (
            q.dtype == k.dtype == v.dtype):
        raise TypeError(f"flash_attention takes float32 or bfloat16 q, k, v "
                        f"of one dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4 \
            or k.shape[:3] != v.shape[:3]:
        raise ValueError(f"q must be (B,H,S,D), k (B,K,Sk,D) and v "
                         f"(B,K,Sk,Dv), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, H, S, D = q.shape
    if k.shape[0] != B or k.shape[3] != D or H % k.shape[1] != 0:
        raise ValueError(f"k, v {tuple(k.shape)} do not fit q "
                         f"{tuple(q.shape)} (batch, head dim, H % K == 0)")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k, v lie on different devices")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("q, k, v must be contiguous")
    if window is not None and (not causal or int(window) < 1
                               or k.shape[2] != S):
        raise ValueError(f"a window (got {window}) must be >= 1, with causal "
                         f"masking and as many keys as queries (S {S}, Sk "
                         f"{k.shape[2]})")
    if int(sink) < 0:
        raise ValueError(f"sink must be >= 0, got {sink}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, *, window: Optional[int] = None,
                    sink: int = 0, round_p: bool = True) -> torch.Tensor:
    """q (B,H,S,D), k (B,K,Sk,D), v (B,K,Sk,Dv) with H % K == 0 ->
    (B,H,S,Dv) in q's dtype. Query head h attends kv head h // (H/K). With
    ``causal``, key c is visible to row r when c <= r and (``window`` is
    None or r - c < window or c < ``sink``). ``round_p`` rounds p to v's
    dtype before the PV product (the TPU kernel); ``round_p=False`` keeps it
    at float32 precision (the model). Same contract as
    ``ref.attention_ref``. On the card the gradient needs ``round_p=False``
    (the backward kernel's p)."""
    _check(q, k, v, causal, window, sink)
    if q.device.type == "cpu":
        _C_PLAIN.inc()
        return attention_ref(q, k, v, causal=causal, window=window,
                             sink=sink, round_p=round_p)
    if meta.active(q):
        return meta.outputs((q, k, v), [(q.shape[:3] + v.shape[3:],
                                         q.dtype)])[0]
    needs_grad = torch.is_grad_enabled() and (
        q.requires_grad or k.requires_grad or v.requires_grad)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, got "
                         f"{q.device}")
    if needs_grad:
        if round_p:
            raise ValueError("the flash-attention backward kernel takes p in "
                             "float32: call with round_p=False to train")
        return _FlashAttention.apply(q, k, v, causal, window, sink)
    return _forward(q, k, v, causal, window, sink, round_p, with_lse=False)[0]


def kernel_dim(D: int, Dv: int) -> int:
    """The query/key dim of the instantiation that takes (D, Dv): D itself,
    or the next one with the same Dv, up to which q and k are padded."""
    fits = [d for d, dv in HEAD_DIM_PAIRS if dv == Dv and d >= D]
    if not fits:
        raise ValueError(f"flash_attention kernel takes (D, Dv) in "
                         f"{HEAD_DIM_PAIRS} (D padded up to one), got "
                         f"({D}, {Dv})")
    return min(fits)


def forward_kernel(D: int, Dv: int, dtype: torch.dtype) -> str:
    """The kernel of ``csrc/flash_attention.cu`` that the forward runs
    for q/k head dim D (padded to ``kernel_dim``), v head dim Dv and
    ``dtype``: ``flash_kernel_wg``, ``flash_kernel_tc`` or
    ``flash_kernel_f32``."""
    if dtype != torch.bfloat16:
        return "flash_kernel_f32"
    return ("flash_kernel_wg" if (kernel_dim(D, Dv), Dv) in WGMMA_FWD_PAIRS
            else "flash_kernel_tc")


def backward_kernel(D: int, Dv: int, dtype: torch.dtype):
    """The (dK/dV, dQ) kernel pair of ``csrc/flash_attention_bwd.cu`` that
    the backward runs for q/k head dim D (padded to ``kernel_dim``), v head
    dim Dv and ``dtype``: ``("dkdv_kernel_wg2", "dq_kernel_wg2")``,
    ``("dkdv_kernel_wg", "dq_kernel_wg")`` (both on wgmma),
    ``("dkdv_kernel_tc", "dq_kernel_tc")`` (mma.sync) or the ``_f32``
    pair."""
    if dtype != torch.bfloat16:
        return "dkdv_kernel_f32", "dq_kernel_f32"
    pair = (kernel_dim(D, Dv), Dv)
    kind = ("wg2" if pair in WGMMA_PAIRS else
            "wg" if pair in WGMMA_BWD_ONE else "tc")
    return f"dkdv_kernel_{kind}", f"dq_kernel_{kind}"


def backward_heads_per_block(B: int, H: int, K: int, Sk: int, D: int,
                             Dv: int, dtype: torch.dtype) -> int:
    """The query heads a dK/dV block of the backward takes, as the
    library's launch decides: on the two-warpgroup pair
    (``backward_kernel``), the kv head's G = H / K where B K ceil(Sk / 64)
    >= ``SUM_HEADS_BLOCKS`` (the block writes dk and dv itself), else 1 (a
    block a query head: with G > 1 it writes fp32 partials, which the dQ
    launch's combine blocks sum; the other pairs always do)."""
    if backward_kernel(D, Dv, dtype)[0] != "dkdv_kernel_wg2":
        return 1
    return H // K if B * K * -(-Sk // 64) >= SUM_HEADS_BLOCKS else 1


def _check_grid(B: int, H: int, S: int, D: int, Dv: int, dtype: torch.dtype,
                backward: bool) -> None:
    """Refuse a shape the launch cannot take: the forward puts B H blocks
    on its grid's y axis; the two-warpgroup backward packs a work item's
    query tile in 16 bits. (The backward's launch function refuses its own
    grids past 65,535 blocks on y, before its first launch.)"""
    if not backward and B * H > _MAX_GRID_Y:
        raise ValueError(f"flash_attention kernel takes B*H <= "
                         f"{_MAX_GRID_Y}, got {B * H}")
    if backward and backward_kernel(D, Dv, dtype)[0] == "dkdv_kernel_wg2" \
            and -(-S // 64) > _MAX_WG2_Q_TILES:
        raise ValueError(f"flash_attention_bwd kernel packs a query tile in "
                         f"16 bits: S <= {64 * _MAX_WG2_Q_TILES}, got {S}")


def _pad_qk(q, k, Dv: int):
    """q and k padded with zero columns to ``kernel_dim``, which leave
    every score as it is (q and k themselves where they fit)."""
    Dqk = q.shape[-1]
    D = kernel_dim(Dqk, Dv)
    if D == Dqk:
        return q, k
    return F.pad(q, (0, D - Dqk)), F.pad(k, (0, D - Dqk))


def _forward(q, k, v, causal, window, sink, round_p, *, with_lse: bool):
    """Launch the forward kernel; returns (o, lse or None)."""
    B, H, S, Dqk = q.shape
    K, Sk, Dv = k.shape[1], k.shape[2], v.shape[3]
    q, k = _pad_qk(q, k, Dv)
    D = q.shape[-1]
    _check_grid(B, H, S, D, Dv, q.dtype, backward=False)
    bf16 = q.dtype == torch.bfloat16
    if bf16 and any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("the bf16 kernel loads 16-byte rows: q, k, v must "
                         "start at 16-byte aligned addresses")
    o = q.new_empty((B, H, S, Dv))
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device) \
        if with_lse else None
    if q.numel() == 0:
        return o, lse
    if Sk == 0:
        raise ValueError("flash_attention needs at least one key")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        build.launch("flash_attention", q.data_ptr(), k.data_ptr(),
                     v.data_ptr(), o.data_ptr(),
                     0 if lse is None else lse.data_ptr(), B, H, K, S, Sk, D,
                     Dv, 1.0 / math.sqrt(Dqk), int(bf16), int(causal),
                     0 if window is None else int(window), int(sink),
                     int(round_p), stream)
    flash_attention.launches += 1
    if bf16 and (D, Dv) in WGMMA_FWD_PAIRS:
        flash_attention.wg_launches += 1
    _C_CUDA.inc()
    sanitize.check_kernel("flash_attention", (q, k, v), (o,))
    return o, lse


def flash_attention_bwd(q, k, v, o, do, lse, causal=True, window=None,
                        sink=0):
    """The gradient of ``flash_attention(q, k, v, causal, window=window,
    sink=sink, round_p=False)`` on the card: (dq, dk, dv) in q's, k's and
    v's dtype, from the forward's ``o`` and ``lse`` and the upstream
    gradient ``do`` (o's shape and dtype). q and k are padded to
    ``kernel_dim`` as the forward pads them, and the padded columns'
    gradients are dropped. One launch of the backward kernel; the plain
    version is ``ref.attention_ref_grads``."""
    _check(q, k, v, causal, window, sink)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_bwd runs on cuda, got {q.device}")
    B, H, S, Dqk = q.shape
    K, Sk, Dv = k.shape[1], k.shape[2], v.shape[3]
    if do.shape != (B, H, S, Dv) or do.dtype != q.dtype \
            or o.shape != do.shape or lse.shape != q.shape[:3] \
            or lse.dtype != torch.float32:
        raise ValueError("flash_attention_bwd takes o and do of shape (B, H, "
                         "S, Dv) in q's dtype and a float32 (B, H, S) lse")
    q, k = _pad_qk(q, k, Dv)
    D = q.shape[-1]
    _check_grid(B, H, S, D, Dv, q.dtype, backward=True)
    bf16 = q.dtype == torch.bfloat16
    do, o = do.contiguous(), o.contiguous()
    if bf16:    # the bf16 kernels load 16-byte rows of o and do
        do, o = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (do, o))
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    if q.numel() == 0:
        return dq[..., :Dqk], dk.zero_()[..., :Dqk], dv.zero_()
    scratch = torch.empty(
        build.scratch_floats("flash_attention_bwd", B, H, K, S, Sk, D, Dv,
                             int(bf16)), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        build.launch("flash_attention_bwd", q.data_ptr(), k.data_ptr(),
                     v.data_ptr(), o.data_ptr(), do.data_ptr(),
                     lse.data_ptr(), scratch.data_ptr(), scratch.numel(),
                     dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), B, H, K, S,
                     Sk, D, Dv, 1.0 / math.sqrt(Dqk), int(bf16), int(causal),
                     0 if window is None else int(window), int(sink), stream)
    flash_attention_bwd.launches += 1
    if "_wg" in backward_kernel(D, Dv, q.dtype)[0]:
        flash_attention_bwd.wg_launches += 1
    _C_BWD.inc()
    sanitize.check_kernel("flash_attention_bwd", (q, k, v, o, do, lse),
                          (dq, dk, dv))
    return dq[..., :Dqk], dk[..., :Dqk], dv


class _FlashAttention(torch.autograd.Function):
    """The kernel pair on the card, p in float32: the forward keeps q, k, v,
    o and the row log-sum-exps for the backward kernel."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, sink):
        o, lse = _forward(q, k, v, causal, window, sink, False,
                          with_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.mask = (causal, window, sink)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, do, lse, *ctx.mask)
        return dq, dk, dv, None, None, None


flash_attention.launches = 0
flash_attention.wg_launches = 0
flash_attention_bwd.launches = 0
flash_attention_bwd.wg_launches = 0
