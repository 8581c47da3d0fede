"""Plain PyTorch versions of the hand-written kernels: the allclose targets
of ``kernels/csrc/*.cu`` and what the wrappers run for tensors on the CPU.

- ``retention_ref`` repeats, op for op in float32, what the reference's
  packed oracle (``repro/kernels/ref.py::retention_ref``) computes.
- ``attention_ref`` is the flash-attention forward with the kernel's kv
  blocking, causal/window/sink mask, either treatment of ``p`` (rounded
  to v's dtype, or float32) and a value head dim apart from the query/key
  one (MLA).
- ``ssm_scan_ref`` is the sequential selective scan, returning the final
  state as well.

Their gradients are autograd through them: ``attention_ref_grads`` and
``ssm_scan_ref_grads`` return them, the plain versions of the backward
kernels (``kernels/csrc/*_bwd.cu``).
"""
from __future__ import annotations

import math

import torch

UT = 0.02585     # thermal voltage at 300 K [V], the default of retention_ref
# packed config rows: [vt, n, ispec, eta, i_floor, jg_coef, c_sn, w, v0, v_min]
N_FIELDS = 10


def _F(u):
    sp = torch.where(u > 40.0, u / 2.0,
                     torch.log1p(torch.exp(torch.clamp_max(u / 2.0, 40.0))))
    return sp * sp


def _leak(p, v, ut=UT):
    vt, n, ispec, eta, i_floor, jg, c_sn, w = p[:8]
    vt_eff = vt - eta * v
    nut = n * ut
    i_ch = ispec * (_F((0.0 - vt_eff) / nut) - _F((0.0 - vt_eff - n * v) / nut))
    return (torch.clamp_min(i_ch, 0.0) + i_floor) * w + jg * v


def retention_ref(params: torch.Tensor, ts: torch.Tensor,
                  ut: float = UT) -> torch.Tensor:
    """params (B, 10) float32, ts (N+1,) log grid -> retention times (B,) [s].

    RK4 over the grid, V clipped to [0, 2] each step, first crossing below
    ``v_min`` interpolated log-linearly; ``ts[-1]`` if V never crosses, and
    also when the row starts crossed (``v0 < v_min``). ``ut`` is the thermal
    voltage [V] of the operating corner, one for the whole batch (the
    reference's oracle fixes it at ``UT``, the 300 K value)."""
    p = params.unbind(1)
    v, v_min, c_sn = p[8], p[9], p[6]

    def f(v):
        return -_leak(p, torch.clamp_min(v, 0.0), ut) \
            / torch.clamp_min(c_sn, 1e-18)

    t_ret = ts[-1].expand_as(v)
    found = v < v_min
    for i in range(ts.shape[0] - 1):
        t0, t1 = ts[i], ts[i + 1]
        dt = t1 - t0
        k1 = f(v)
        k2 = f(v + 0.5 * dt * k1)
        k3 = f(v + 0.5 * dt * k2)
        k4 = f(v + dt * k3)
        v_new = torch.clamp(v + dt / 6.0 * (k1 + 2 * k2 + 2 * k3 + k4), 0.0, 2.0)
        crossed = (v_new < v_min) & ~found
        frac = torch.clamp((v - v_min) / torch.clamp_min(v - v_new, 1e-9),
                           0.0, 1.0)
        t_cross = torch.exp(torch.log(t0) + frac *
                            (torch.log(t1) - torch.log(t0)))
        t_ret = torch.where(crossed, t_cross, t_ret)
        found = found | crossed
        v = v_new
    return t_ret


# ---------------------------------------------------------------------------
# flash attention forward
# ---------------------------------------------------------------------------

NEG = -0.7 * torch.finfo(torch.float32).max     # the reference's mask value
BLOCK_K = 64    # kv tile of kernels/csrc/flash_attention.cu


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = True, *, window=None, sink: int = 0,
                  round_p: bool = True, scale=None) -> torch.Tensor:
    """q (B,H,S,D), k (B,K,Sk,D), v (B,K,Sk,Dv) with H % K == 0 -> (B,H,S,Dv)
    in q's dtype.

    The online softmax of ``repro/kernels/flash_attention.py::_flash_kernel``
    over kv tiles of ``BLOCK_K`` columns: scores in float32 scaled by
    ``scale`` (None: 1/sqrt(D); a caller that pads q and k with zeros passes
    the scale of the unpadded D), masked entries set to ``NEG``, running max
    m, sum l and
    accumulator in float32, l summing the unrounded p and clamped to >=
    1e-30. Query head h reads kv head h // (H/K) (GQA).

    Mask (``causal``): key c is visible to row r when c <= r and (``window``
    is None or r - c < window or c < ``sink``), the mask of the model's
    ``repro/models/attention.py::causal_attention`` with the queries at
    positions 0..S-1. ``round_p``: p is rounded to v's dtype before the PV
    product (the TPU kernel), else kept in float32 (the model).

    A kv tile the kernel skips (wholly masked for every row of its q tile)
    is processed here: for a row that has seen a real key it leaves m, l and
    the accumulator bit for bit unchanged, and for one that has not, what it
    adds is wiped by alpha = exp(NEG - m) = 0 at the row's first real key,
    so processing it is the same as skipping it."""
    B, H, S, D = q.shape
    K, Sk = k.shape[1], k.shape[2]
    G = H // K
    scale = 1.0 / math.sqrt(D) if scale is None else scale
    qf = q.float()
    kf = k.float().repeat_interleave(G, dim=1)
    vg = v.repeat_interleave(G, dim=1)
    m = torch.full((B, H, S), NEG, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, H, S), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, H, S, v.shape[3]), dtype=torch.float32,
                      device=q.device)
    rows = torch.arange(S, device=q.device)[:, None]
    for j0 in range(0, Sk, BLOCK_K):
        s = (qf @ kf[:, :, j0:j0 + BLOCK_K].transpose(-1, -2)) * scale
        if causal:
            cols = torch.arange(j0, j0 + s.shape[-1], device=q.device)[None]
            visible = rows >= cols
            if window is not None:
                visible = visible & ((rows - cols < window) | (cols < sink))
            s = torch.where(visible, s, NEG)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(-1)
        if round_p:
            p = p.to(v.dtype).float()
        acc = acc * alpha[..., None] + p @ vg[:, :, j0:j0 + BLOCK_K].float()
        m = m_new
    return (acc / torch.clamp_min(l, 1e-30)[..., None]).to(q.dtype)


def _grads(fn, inputs, grads_out):
    """Autograd of ``fn(*inputs)`` against the upstream gradients
    ``grads_out`` (None for an output that gets none)."""
    leaves = [t.detach().requires_grad_(True) for t in inputs]
    with torch.enable_grad():
        outs = fn(*leaves)
        outs = outs if isinstance(outs, tuple) else (outs,)
        pairs = [(o, g) for o, g in zip(outs, grads_out) if g is not None]
        return torch.autograd.grad([o for o, _ in pairs],
                                   leaves, [g for _, g in pairs])


def attention_ref_grads(q, k, v, do, causal: bool = True, *, window=None,
                        sink: int = 0):
    """(dq, dk, dv) of ``attention_ref`` with p in float32 (the model's, and
    the backward kernel's) against the upstream gradient ``do``, by
    autograd; in q's, k's and v's dtype."""
    return _grads(lambda q, k, v: attention_ref(
        q, k, v, causal=causal, window=window, sink=sink, round_p=False),
        (q, k, v), (do,))


ULP_FLOOR = 2.0 ** -10


def bf16_ulp_gaps(got: torch.Tensor, want: torch.Tensor,
                  floor: float = ULP_FLOOR):
    """(largest gap in bf16 ulps, share of elements that differ) between
    two tensors of bf16 values: each gap in ulps of max(|got|, |want|,
    ``floor`` * max|want|). The floor: float32 rounding in an attention
    accumulator is relative to the output's scale, so an element whose
    weighted sum cancels to near zero can move by many of its own ulps."""
    got, want = got.double(), want.double()
    mag = torch.maximum(torch.maximum(got.abs(), want.abs()),
                        floor * want.abs().max())
    ulp = torch.ldexp(torch.ones_like(mag), torch.frexp(mag).exponent - 8)
    gap = (got - want).abs()
    return (gap / ulp).max().item(), (gap > 0).double().mean().item()


# ---------------------------------------------------------------------------
# selective scan
# ---------------------------------------------------------------------------


def ssm_scan_ref(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                 Bc: torch.Tensor, Cc: torch.Tensor, D: torch.Tensor):
    """Sequential selective scan from h0 = 0, all float32.

    x/dt (B,S,di); Bc/Cc (B,S,n); A (di,n); D (di,) -> (y (B,S,di),
    h_final (B,di,n)). Each step: ``h = exp(dt*A)*h + (dt*x) B``, then
    ``y = <h, C> + D*x``."""
    Bsz, S, di = x.shape
    h = torch.zeros((Bsz, di, A.shape[1]), dtype=torch.float32,
                    device=x.device)
    ys = []
    for t in range(S):
        a = torch.exp(dt[:, t, :, None] * A)
        h = a * h + (dt[:, t] * x[:, t])[..., None] * Bc[:, t, None, :]
        ys.append((h * Cc[:, t, None, :]).sum(-1) + D * x[:, t])
    return torch.stack(ys, dim=1), h


def ssm_scan_ref_grads(x, dt, A, Bc, Cc, D, dy, dh_final=None):
    """(dx, ddt, dA, dBc, dCc, dD) of ``ssm_scan_ref`` against the upstream
    gradients ``dy`` (B,S,di) and ``dh_final`` (B,di,n) or None, by
    autograd."""
    return _grads(ssm_scan_ref, (x, dt, A, Bc, Cc, D), (dy, dh_final))
