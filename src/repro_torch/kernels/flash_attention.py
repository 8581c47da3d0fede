"""Flash-attention forward wrapper: ``flash_attention(q, k, v, causal, *,
window, sink, round_p)``.

On CUDA tensors it launches the hand-written kernel of
``kernels/csrc/flash_attention.cu`` (built on first use by
``kernels.build``) and counts the launch in ``flash_attention.launches``
and in the ``kernels.dispatch.flash_attention.cuda`` counter; it never
falls back. On CPU tensors it runs the plain version,
``kernels.ref.attention_ref``, counted in
``kernels.dispatch.flash_attention.plain``. Under the sanitizer
(``analysis.sanitize.wrap``) the kernel's output is checked for a NaN its
inputs did not hold.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch import obs
from repro_torch.analysis import sanitize
from repro_torch.kernels import build
from repro_torch.kernels.ref import attention_ref

HEAD_DIMS = (16, 32, 64, 96, 128)   # the D the kernel is instantiated for
_MAX_GRID_Y = 65535                 # B * H blocks along the grid's y axis

_C_CUDA = obs.counter("kernels.dispatch.flash_attention.cuda")
_C_PLAIN = obs.counter("kernels.dispatch.flash_attention.plain")


def _check(q, k, v, causal, window, sink) -> None:
    if q.dtype not in (torch.float32, torch.bfloat16) or not (
            q.dtype == k.dtype == v.dtype):
        raise TypeError(f"flash_attention takes float32 or bfloat16 q, k, v "
                        f"of one dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"q must be (B,H,S,D) and k, v (B,K,Sk,D), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
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
    """q (B,H,S,D), k/v (B,K,Sk,D) with H % K == 0 -> (B,H,S,D) in q's dtype.
    Query head h attends kv head h // (H/K). With ``causal``, key c is
    visible to row r when c <= r and (``window`` is None or r - c < window
    or c < ``sink``). ``round_p`` rounds p to v's dtype before the PV
    product (the TPU kernel); ``round_p=False`` keeps it at float32
    precision (the model). Same contract as ``ref.attention_ref``."""
    _check(q, k, v, causal, window, sink)
    if q.device.type == "cpu":
        _C_PLAIN.inc()
        return attention_ref(q, k, v, causal=causal, window=window,
                             sink=sink, round_p=round_p)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, got "
                         f"{q.device}")
    B, H, S, D = q.shape
    K, Sk = k.shape[1], k.shape[2]
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention kernel takes D in {HEAD_DIMS}, "
                         f"got {D}")
    if B * H > _MAX_GRID_Y:
        raise ValueError(f"flash_attention kernel takes B*H <= "
                         f"{_MAX_GRID_Y}, got {B * H}")
    bf16 = q.dtype == torch.bfloat16
    if bf16 and any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("the bf16 kernel loads 16-byte rows: q, k, v must "
                         "start at 16-byte aligned addresses")
    o = torch.empty_like(q)
    if q.numel() == 0:
        return o
    if Sk == 0:
        raise ValueError("flash_attention needs at least one key")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        build.launch("flash_attention", q.data_ptr(), k.data_ptr(),
                     v.data_ptr(), o.data_ptr(), B, H, K, S, Sk, D,
                     1.0 / math.sqrt(D), int(bf16), int(causal),
                     0 if window is None else int(window), int(sink),
                     int(round_p), stream)
    flash_attention.launches += 1
    _C_CUDA.inc()
    sanitize.check_kernel("flash_attention", (q, k, v), (o,))
    return o


flash_attention.launches = 0
