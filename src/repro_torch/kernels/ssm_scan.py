"""Selective-scan wrapper: ``ssm_scan(x, dt, A, Bc, Cc, D) -> (y, h_final)``,
differentiable.

On CUDA tensors the forward launches the hand-written kernel of
``kernels/csrc/ssm_scan.cu`` (built on first use by ``kernels.build``),
counted in ``ssm_scan.launches`` and the ``kernels.dispatch.ssm_scan.cuda``
counter. When autograd will need the gradient it runs as ``_SsmScan`` (a
``torch.autograd.Function``): the forward also saves the state entering
every ``STATE_EVERY``-th step, and the backward launches
``kernels/csrc/ssm_scan_bwd.cu``, counted in ``ssm_scan_bwd.launches`` and
``kernels.dispatch.ssm_scan_bwd.cuda``. Neither falls back. On CPU tensors
it runs the plain version, ``kernels.ref.ssm_scan_ref`` (counted in
``kernels.dispatch.ssm_scan.plain``), under plain autograd; on meta
tensors inside ``kernels.meta.shapes_only()`` (the dry run) it returns the
outputs' shapes. Under the sanitizer (``analysis.sanitize.wrap``) the
kernels' outputs are checked for a NaN their inputs did not hold.
"""
from __future__ import annotations

import torch

from repro_torch import obs
from repro_torch.analysis import sanitize
from repro_torch.kernels import build, meta
from repro_torch.kernels.ref import ssm_scan_ref

STATE_SIZES = (4, 8, 16, 32)    # the n the kernels are instantiated for
STATE_EVERY = 64                # steps between saved states (ssm_scan.cuh)
# blocks along a grid's y or z axis: B in both kernels, and the backward's
# chunks of STATE_EVERY steps
_MAX_GRID_YZ = 65535

_C_CUDA = obs.counter("kernels.dispatch.ssm_scan.cuda")
_C_PLAIN = obs.counter("kernels.dispatch.ssm_scan.plain")
_C_BWD = obs.counter("kernels.dispatch.ssm_scan_bwd.cuda")


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
    if meta.active(x):
        B, S, di = x.shape
        return meta.outputs((x, dt, A, Bc, Cc, D),
                            [((B, S, di), x.dtype),
                             ((B, di, A.shape[1]), x.dtype)])
    if x.device.type != "cuda":
        raise ValueError(f"ssm_scan runs on cuda or cpu, got {x.device}")
    if A.shape[1] not in STATE_SIZES:
        raise ValueError(f"ssm_scan kernel takes n in {STATE_SIZES}, got "
                         f"{A.shape[1]}")
    _check_grid(x.shape[0])
    inputs = (x, dt, A, Bc, Cc, D)
    if torch.is_grad_enabled() and any(t.requires_grad for t in inputs):
        return _SsmScan.apply(*inputs)
    return _forward(*inputs, with_states=False)[:2]


def _check_grid(B: int, S: int = 0) -> None:
    """The kernels put B (and the backward, called with ``S``, its ceil(S /
    STATE_EVERY) chunks) on a grid's y or z axis: at most 65,535 blocks
    each."""
    chunks = -(-S // STATE_EVERY)
    if max(B, chunks) > _MAX_GRID_YZ:
        raise ValueError(f"ssm_scan kernels take B and ceil(S / "
                         f"{STATE_EVERY}) <= {_MAX_GRID_YZ}, got B {B}, S "
                         f"{S}")


def _forward(x, dt, A, Bc, Cc, D, *, with_states: bool):
    """Launch the forward kernel; returns (y, h_final, states or None)."""
    B, S, di = x.shape
    n = A.shape[1]
    y = torch.empty((B, S, di), dtype=torch.float32, device=x.device)
    h_final = torch.empty((B, di, n), dtype=torch.float32, device=x.device)
    states = torch.empty((B, -(-S // STATE_EVERY), di, n),
                         dtype=torch.float32, device=x.device) \
        if with_states else None
    if y.numel() == 0:
        return y, h_final.zero_(), states   # S == 0: the state stays h0 = 0
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        build.launch("ssm_scan", x.data_ptr(), dt.data_ptr(), A.data_ptr(),
                     Bc.data_ptr(), Cc.data_ptr(), D.data_ptr(), y.data_ptr(),
                     h_final.data_ptr(),
                     0 if states is None else states.data_ptr(), B, S, di, n,
                     stream)
    ssm_scan.launches += 1
    _C_CUDA.inc()
    sanitize.check_kernel("ssm_scan", (x, dt, A, Bc, Cc, D), (y, h_final))
    return y, h_final, states


def ssm_scan_bwd(x, dt, A, Bc, Cc, D, states, dy, dh_final=None):
    """The gradient of ``ssm_scan`` on the card: (dx, ddt, dA, dBc, dCc, dD)
    from the forward's inputs, the ``states`` its training launch saved,
    the upstream gradient ``dy`` (B,S,di) and ``dh_final`` (B,di,n) or
    None. One launch of the backward kernel; the plain version is
    ``ref.ssm_scan_ref_grads``."""
    _check(x, dt, A, Bc, Cc, D)
    if x.device.type != "cuda":
        raise ValueError(f"ssm_scan_bwd runs on cuda, got {x.device}")
    B, S, di = x.shape
    n = A.shape[1]
    if n not in STATE_SIZES:
        raise ValueError(f"ssm_scan_bwd kernel takes n in {STATE_SIZES}, got "
                         f"{n}")
    _check_grid(B, S)
    dy = dy.float().contiguous()
    if dh_final is not None:
        dh_final = dh_final.float().contiguous()
        if dh_final.shape != (B, di, n):
            raise ValueError(f"dh_final must be {(B, di, n)}, got "
                             f"{tuple(dh_final.shape)}")
    want = (B, -(-S // STATE_EVERY), di, n)
    if dy.shape != x.shape or tuple(states.shape) != want:
        raise ValueError(f"ssm_scan_bwd takes dy {tuple(x.shape)} and states "
                         f"{want}, got {tuple(dy.shape)} and "
                         f"{tuple(states.shape)}")
    dx, ddt = torch.empty_like(x), torch.empty_like(x)
    dA, dD = torch.empty_like(A), torch.empty_like(D)
    dB, dC = torch.empty_like(Bc), torch.empty_like(Cc)
    if dx.numel() == 0:
        return dx, ddt, dA.zero_(), dB, dC, dD.zero_()
    scratch = torch.empty(build.scratch_floats("ssm_scan_bwd", B, S, di, n),
                          dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        build.launch("ssm_scan_bwd", x.data_ptr(), dt.data_ptr(),
                     A.data_ptr(), Bc.data_ptr(), Cc.data_ptr(), D.data_ptr(),
                     states.data_ptr(), dy.data_ptr(),
                     0 if dh_final is None else dh_final.data_ptr(),
                     dx.data_ptr(), ddt.data_ptr(), dA.data_ptr(),
                     dB.data_ptr(), dC.data_ptr(), dD.data_ptr(),
                     scratch.data_ptr(), scratch.numel(), B, S, di, n, stream)
    ssm_scan_bwd.launches += 1
    _C_BWD.inc()
    sanitize.check_kernel("ssm_scan_bwd", (x, dt, A, Bc, Cc, D, dy),
                          (dx, ddt, dA, dB, dC, dD))
    return dx, ddt, dA, dB, dC, dD


class _SsmScan(torch.autograd.Function):
    """The kernel pair on the card: the forward keeps its inputs and the
    states entering every ``STATE_EVERY``-th step for the backward kernel."""

    @staticmethod
    def forward(ctx, x, dt, A, Bc, Cc, D):
        y, h_final, states = _forward(x, dt, A, Bc, Cc, D, with_states=True)
        ctx.save_for_backward(x, dt, A, Bc, Cc, D, states)
        return y, h_final

    @staticmethod
    def backward(ctx, dy, dh_final):
        x, dt, A, Bc, Cc, D, states = ctx.saved_tensors
        return ssm_scan_bwd(x, dt, A, Bc, Cc, D, states, dy, dh_final)


ssm_scan.launches = 0
ssm_scan_bwd.launches = 0
