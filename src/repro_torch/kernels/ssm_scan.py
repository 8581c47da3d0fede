"""Selective-scan wrapper: ``ssm_scan(x, dt, A, Bc, Cc, D) -> (y, h_final)``.

On CUDA tensors it launches the hand-written kernel of
``kernels/csrc/ssm_scan.cu`` (built on first use by ``kernels.build``) and
counts the launch in ``ssm_scan.launches`` and in the
``kernels.dispatch.ssm_scan.cuda`` counter; it never falls back. On CPU
tensors it runs the plain version, ``kernels.ref.ssm_scan_ref``, counted in
``kernels.dispatch.ssm_scan.plain``. Under the sanitizer
(``analysis.sanitize.wrap``) the kernel's outputs are checked for a NaN its
inputs did not hold.
"""
from __future__ import annotations

import torch

from repro_torch import obs
from repro_torch.analysis import sanitize
from repro_torch.kernels import build
from repro_torch.kernels.ref import ssm_scan_ref

STATE_SIZES = (4, 8, 16, 32)    # the n the kernel is instantiated for

_C_CUDA = obs.counter("kernels.dispatch.ssm_scan.cuda")
_C_PLAIN = obs.counter("kernels.dispatch.ssm_scan.plain")


def _check(x, dt, A, Bc, Cc, D) -> None:
    named = dict(x=x, dt=dt, A=A, Bc=Bc, Cc=Cc, D=D)
    bad = [k for k, t in named.items() if t.dtype != torch.float32]
    if bad:
        raise TypeError(f"ssm_scan takes float32 tensors; {bad} are not")
    if x.dim() != 3 or A.dim() != 2:
        raise ValueError(f"x must be (B,S,di) and A (di,n), got "
                         f"{tuple(x.shape)} and {tuple(A.shape)}")
    B, S, di = x.shape
    n = A.shape[1]
    want = dict(x=(B, S, di), dt=(B, S, di), A=(di, n), Bc=(B, S, n),
                Cc=(B, S, n), D=(di,))
    wrong = {k: tuple(named[k].shape) for k in want
             if tuple(named[k].shape) != want[k]}
    if wrong:
        raise ValueError(f"ssm_scan shapes {wrong}, expected "
                         f"{ {k: want[k] for k in wrong} }")
    if len({t.device for t in named.values()}) != 1:
        raise ValueError("ssm_scan inputs lie on different devices")
    if not all(t.is_contiguous() for t in named.values()):
        raise ValueError("ssm_scan inputs must be contiguous")


def ssm_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             Bc: torch.Tensor, Cc: torch.Tensor, D: torch.Tensor):
    """x/dt (B,S,di), Bc/Cc (B,S,n), A (di,n), D (di,), all float32 ->
    (y (B,S,di), h_final (B,di,n)); h0 = 0. Same contract as
    ``ref.ssm_scan_ref``."""
    _check(x, dt, A, Bc, Cc, D)
    if x.device.type == "cpu":
        _C_PLAIN.inc()
        return ssm_scan_ref(x, dt, A, Bc, Cc, D)
    if x.device.type != "cuda":
        raise ValueError(f"ssm_scan runs on cuda or cpu, got {x.device}")
    B, S, di = x.shape
    n = A.shape[1]
    if n not in STATE_SIZES:
        raise ValueError(f"ssm_scan kernel takes n in {STATE_SIZES}, got {n}")
    y = torch.empty((B, S, di), dtype=torch.float32, device=x.device)
    h_final = torch.empty((B, di, n), dtype=torch.float32, device=x.device)
    if y.numel() == 0:
        return y, h_final.zero_()       # S == 0: the state stays h0 = 0
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        build.launch("ssm_scan", x.data_ptr(), dt.data_ptr(), A.data_ptr(),
                     Bc.data_ptr(), Cc.data_ptr(), D.data_ptr(), y.data_ptr(),
                     h_final.data_ptr(), B, S, di, n, stream)
    ssm_scan.launches += 1
    _C_CUDA.inc()
    sanitize.check_kernel("ssm_scan", (x, dt, A, Bc, Cc, D), (y, h_final))
    return y, h_final


ssm_scan.launches = 0
