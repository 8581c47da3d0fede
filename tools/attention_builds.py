#!/usr/bin/env python3
"""The flash-attention forward and backward kernels of two checkouts on the
card: bit for bit, and within phase 8's gates where a bf16 forward pair
changed kernels (``REDESIGNED``, empty: no forward changed), and within
phase 19's gate where a bf16 backward pair did (``REDESIGNED_BWD``: (96,
96), from the mma.sync pair to the two-warpgroup wgmma one).

    python3 tools/attention_builds.py PARENT_ROOT CHANGE_ROOT

Each checkout's kernel is built from its own sources (into its own
``build/repro_torch/``) and run in a process of its own, importing that
checkout's ``repro_torch``, in the order parent, change, change, parent.
Each run computes the forward kernel's output at every shape of
``chip_smoke.py``'s ``ATTN_SHAPES`` (causal and not), ``ATTN_MASK_CASES``,
``MOE_ATTN_SHAPES`` and ``FAMILY_ATTN_SHAPES``, in float32 and bf16, with p
rounded and in
float32, from the same numpy inputs (``chip_smoke.attn_inputs``, seed 0),
and the backward kernel's (dq, dk, dv) at every case of
``chip_smoke.ATTN_BWD_CASES`` and ``chip_smoke.MLA_BWD_CASES`` (the upstream
gradient from seed 1) on o and lse from the plain version, so that both
builds' backward kernels see the same inputs; and it times (``chip_smoke.
median_ms``) the hymba-1.5b serving call (bf16, window 1,024, sink 128, p
in float32 and rounded) and its backward, the moonshot-v1-16b-a3b,
deepseek-v3 MLA, phi-3-vision-4.2b (D = 96) and musicgen-medium (D = 64)
serving calls (bf16, p in float32 and rounded; SDPA's causal call beside
each, p rounded), the bf16 MLA backward
at deepseek-v3's training shape, and the bf16 (128, 128) backward at
internlm2-1.8b's and moonshot's training shapes and the (96, 96) one at
phi-3-vision-4.2b's (``chip_smoke.ATTN_BWD_CASES``) with SDPA's backward on
cuDNN beside it (``chip_smoke.sdpa_backward_ms``), each with its three
kernels' device times (``chip_smoke.kernel_split_ms``), and the (96, 96)
and (128, 128) dK/dV and dQ kernels' registers and spills from the build's
``-Xptxas -v`` report (``chip_smoke.bwd_kernels``). Each run prints its
times as it takes them.
Every output must be bit-equal across the four runs, except the bf16
forward at (D, Dv) in ``REDESIGNED`` and the bf16 backward at (D, Dv) in
``REDESIGNED_BWD``, whose kernels the change replaced: there each build's
two runs must be bit-equal and the change's output lie within phase 8's
gates of the parent's (p in float32: ``chip_smoke.MAX_ULPS_P_F32`` and
``MAX_SHARE_P_F32``; p rounded: ``chip_smoke.TOL_ATTN``), or, for the
backward, each gradient within phase 19's ``chip_smoke.RTOL_ATTN_BWD`` of
the parent's (max|change - parent| / max|parent|: the products' summation
order changed).
Outputs compared bit for bit are kept as SHA-256 digests. The script
prints each run's times and the comparisons, and exits 1 if one fails.
It needs one CUDA device and ``nvcc``.
"""
from __future__ import annotations

import argparse
import hashlib
import subprocess
import sys
import tempfile
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]


def digest(t) -> str:
    """SHA-256 of a tensor's bytes, with its dtype and shape."""
    import torch
    t = t.detach().cpu().contiguous()
    return (f"{t.dtype} {tuple(t.shape)} " + hashlib.sha256(
        t.view(-1).view(torch.uint8).numpy().tobytes()).hexdigest())


# the bf16 forward instantiations whose kernel the change replaced
REDESIGNED = set()
# the bf16 backward instantiations whose kernels the change replaced
# (dkdv_kernel_tc / dq_kernel_tc -> dkdv_kernel_wg2 / dq_kernel_wg2)
REDESIGNED_BWD = {(96, 96)}
# the bf16 backward's timed shapes, by ATTN_BWD_CASES' labels: (128, 128)
# at internlm2-1.8b's and moonshot's, (96, 96) at phi-3-vision-4.2b's
BWD_TIMED = ("internlm2", "moonshot", "phi")
# the serving calls timed: moonshot-v1-16b-a3b's, deepseek-v3's,
# phi-3-vision-4.2b's and musicgen-medium's prefill
SERVE_SHAPES = ((4, 16, 16, 1000, 128), (4, 128, 128, 1000, 192, 128),
                (4, 32, 32, 1000, 96), (4, 24, 24, 1000, 64))


def plain_lse(q, k, causal=True, window=None, sink=0):
    """Each row's log-sum-exp of the scaled, masked scores, in float32, by
    plain torch (the forward kernels' lse, from no kernel)."""
    import math
    import torch
    G = q.shape[1] // k.shape[1]
    s = (q.float() @ k.float().repeat_interleave(G, 1).transpose(-1, -2)) \
        / math.sqrt(q.shape[-1])
    if causal:
        r = torch.arange(s.shape[-2], device=s.device)[:, None]
        c = torch.arange(s.shape[-1], device=s.device)[None]
        vis = c <= r
        if window is not None:
            vis &= (r - c < window) | (c < sink)
        s = s.masked_fill(~vis, -math.inf)
    return torch.logsumexp(s, -1)


def note(ms: dict, key: str) -> None:
    """Print one reading as it is taken (a later failure keeps it)."""
    print(f"  {key}: {ms[key]}", flush=True)


def dump(root: Path, out: Path) -> None:
    """Every output of ``root``'s kernels and their times into ``out``
    (``torch.save``)."""
    sys.path.insert(0, str(HERE))
    import chip_smoke as cs                 # puts HERE/src on sys.path
    sys.path.insert(0, str(root / "src"))   # ... and root's ahead of it
    import numpy as np
    import torch
    from repro_torch.kernels import flash_attention as kflash
    from repro_torch.kernels import ref
    if not Path(kflash.__file__).resolve().is_relative_to(root.resolve()):
        raise SystemExit(f"imported {kflash.__file__}, not {root}'s")
    dev = torch.device("cuda")
    print(f"run of {root}", flush=True)
    cases = ([(s, causal, None, 0) for s in cs.ATTN_SHAPES
              for causal in (True, False)]
             + [(c[:5], True, c[5], c[6]) for c in cs.ATTN_MASK_CASES]
             + [(s, True, None, 0) for s in cs.MOE_ATTN_SHAPES
                + cs.FAMILY_ATTN_SHAPES])
    outs = {}
    for shape, causal, window, sink in cases:
        D, Dv = shape[4], shape[5] if len(shape) > 5 else shape[4]
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = cs.attn_inputs(shape, dtype, 0, dev)
            for round_p in (True, False):
                o = kflash.flash_attention(q, k, v, causal, window=window,
                                           sink=sink, round_p=round_p)
                key = (f"{shape} {dtype} causal={causal} window={window} "
                       f"sink={sink} round_p={round_p}")
                outs[key] = (o.cpu() if dtype == torch.bfloat16
                             and (D, Dv) in REDESIGNED else digest(o))
    bwd_cases = ([((B, H, K, S, D), window, sink, dtype)
                  for B, H, K, S, D, window, sink, dtype in cs.ATTN_BWD_CASES]
                 + [((B, H, K, S, D, Dv), None, 0, dtype)
                    for B, H, K, S, D, Dv, dtype in cs.MLA_BWD_CASES])
    for shape, window, sink, dtype in bwd_cases:
        dt = getattr(torch, dtype)
        q, k, v = cs.attn_inputs(shape, dt, 0, dev)
        Dv = v.shape[-1]
        do = torch.from_numpy(np.random.default_rng(1).normal(
            size=q.shape[:3] + (Dv,)).astype(np.float32)).to(dev, dt)
        o = ref.attention_ref(q, k, v, window=window, sink=sink,
                              round_p=False)
        lse = plain_lse(q, k, True, window, sink)
        tol = dtype == "bfloat16" and (shape[4], Dv) in REDESIGNED_BWD
        for name, g in zip(("dq", "dk", "dv"), kflash.flash_attention_bwd(
                q, k, v, o, do, lse, True, window, sink)):
            outs[f"bwd {shape} {dtype} window={window} sink={sink} "
                 f"{name}"] = g.cpu() if tol else digest(g)
        del q, k, v, do, o, lse
        torch.cuda.empty_cache()
    ms = {}
    for label, case in zip(cs.ATTN_BWD_TIMED, cs.ATTN_BWD_CASES):
        if label not in BWD_TIMED:
            continue
        shape, window, sink = case[:5], case[5], case[6]
        q, k, v = cs.attn_inputs(shape, torch.bfloat16, 0, dev)
        do = cs.attn_inputs(shape, torch.bfloat16, 1, dev)[0]
        o, lse = kflash._forward(q, k, v, True, window, sink, False,
                                 with_lse=True)
        def bwd():
            return kflash.flash_attention_bwd(q, k, v, o, do, lse, True,
                                              window, sink)
        ms[f"{label}_bwd"] = cs.median_ms(bwd)
        note(ms, f"{label}_bwd")
        ms[f"{label}_bwd_stages"] = cs.kernel_split_ms(bwd,
                                                       cs.ATTN_BWD_KERNELS)
        note(ms, f"{label}_bwd_stages")
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        backend, ms[f"{label}_bwd_sdpa"] = cs.sdpa_backward_ms(leaves, do)
        ms[f"{label}_bwd_sdpa_backend"] = backend
        note(ms, f"{label}_bwd_sdpa")
        del q, k, v, do, o, lse, leaves
        torch.cuda.empty_cache()
    B, H, K, S, D, Dv, _ = cs.MLA_BWD_CASES[0]
    q, k, v = cs.attn_inputs((B, H, K, S, D, Dv), torch.bfloat16, 0, dev)
    do = torch.from_numpy(np.random.default_rng(1).normal(
        size=(B, H, S, Dv)).astype(np.float32)).to(dev, torch.bfloat16)
    o, lse = kflash._forward(q, k, v, True, None, 0, False, with_lse=True)
    for D in (96, 128):
        route, regs, _ = cs.bwd_kernels(D, D)
        ms[f"bwd_{D}_kernels"] = {"route": route, **regs}
        note(ms, f"bwd_{D}_kernels")
    ms["mla_bwd"] = cs.median_ms(lambda: kflash.flash_attention_bwd(
        q, k, v, o, do, lse))
    del q, k, v, do, o, lse
    torch.cuda.empty_cache()
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for shape in SERVE_SHAPES:
        q, k, v = cs.attn_inputs(shape, torch.bfloat16, 0, dev)
        for round_p in (False, True):
            ms[f"{shape} round_p={round_p}"] = cs.median_ms(
                lambda: kflash.flash_attention(q, k, v, round_p=round_p))
        try:
            ms[f"{shape} sdpa"] = cs.median_ms(lambda: sdpa(
                q, k, v, is_causal=True, enable_gqa=True))
        except RuntimeError as err:
            ms[f"{shape} sdpa"] = f"not taken: {str(err).splitlines()[0]}"
        del q, k, v
        torch.cuda.empty_cache()
    q, k, v = cs.attn_inputs((4, 25, 5, 1128, 64), torch.bfloat16, 0, dev)
    ms["hymba"] = cs.median_ms(lambda: kflash.flash_attention(
        q, k, v, window=1024, sink=128, round_p=False))
    ms["hymba round_p=True"] = cs.median_ms(lambda: kflash.flash_attention(
        q, k, v, window=1024, sink=128, round_p=True))
    do = cs.attn_inputs((4, 25, 5, 1128, 64), torch.bfloat16, 1, dev)[0]
    o, lse = kflash._forward(q, k, v, True, 1024, 128, False, with_lse=True)
    ms["hymba_bwd"] = cs.median_ms(lambda: kflash.flash_attention_bwd(
        q, k, v, o, do, lse, True, 1024, 128))
    torch.save({"outs": outs, "ms": ms}, out)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("roots", nargs=2, type=Path,
                    help="the parent's and the change's checkout")
    ap.add_argument("--dump", type=Path, default=None,
                    help="(internal) run one root and save its outputs here")
    args = ap.parse_args()
    if args.dump is not None:
        dump(args.roots[0], args.dump)
        return 0
    import torch
    sys.path.insert(0, str(HERE))
    import chip_smoke as cs
    runs = []
    with tempfile.TemporaryDirectory() as tmp:
        for i, (label, root) in enumerate(
                (("parent", args.roots[0]), ("change", args.roots[1]),
                 ("change", args.roots[1]), ("parent", args.roots[0]))):
            out = Path(tmp) / f"run{i}.pt"
            subprocess.run([sys.executable, __file__, str(root), str(root),
                            "--dump", str(out)], check=True)
            runs.append((label, torch.load(out)))
    parent, change = runs[0][1]["outs"], runs[1][1]["outs"]
    bit = sorted(key for key, o in parent.items() if isinstance(o, str))
    tol = sorted(key for key in parent if key not in bit)
    differ = sorted({key for _, r in runs[1:] for key in bit
                     if r["outs"][key] != parent[key]})
    for label, r in runs:
        print(f"{label}: " + ", ".join(
            f"{name} {t:.4f} ms" if isinstance(t, float) else f"{name} {t}"
            for name, t in r["ms"].items()))
    print(f"{len(bit)} outputs compared bit for bit, {len(differ)} differ "
          f"between the four runs")
    for key in differ:
        print(f"  differs: {key}")
    failed = list(differ)
    from repro_torch.kernels import ref
    for key in tol:
        same = all(torch.equal(runs[i][1]["outs"][key], runs[j][1]["outs"][key])
                   for i, j in ((0, 3), (1, 2)))
        a, b = change[key], parent[key]
        err = (a.float() - b.float()).abs().max().item()
        if key.startswith("bwd "):
            gate = cs.RTOL_ATTN_BWD["bfloat16"]
            rel = err / b.float().abs().max().item()
            ok = rel <= gate
            gap = (f"max abs {err:.3e}, {rel:.3e} of max|parent| (gate "
                   f"{gate})")
        elif key.endswith("round_p=True"):
            ok = err <= cs.TOL_ATTN["bfloat16"]
            gap = f"max abs {err:.3e} (gate {cs.TOL_ATTN['bfloat16']})"
        else:
            ulps, share = ref.bf16_ulp_gaps(a, b)
            ok = ulps <= cs.MAX_ULPS_P_F32 and share <= cs.MAX_SHARE_P_F32
            gap = (f"max abs {err:.3e}, {ulps:.3g} ulp, {100 * share:.4f} % "
                   f"of elements (gates {cs.MAX_ULPS_P_F32} ulp, "
                   f"{100 * cs.MAX_SHARE_P_F32} %)")
        print(f"{key}: each build twice bit-equal {same}, change vs parent "
              f"{gap}")
        if not same or not ok:
            failed.append(key)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
