#!/usr/bin/env python3
"""The flash-attention forward and backward kernels of two checkouts on the
card: bit for bit, and within the backward's gate where the bf16 MLA
backward's sum order changed.

    python3 tools/attention_builds.py PARENT_ROOT CHANGE_ROOT

Each checkout's kernel is built from its own sources (into its own
``build/repro_torch/``) and run in a process of its own, importing that
checkout's ``repro_torch``, in the order parent, change, change, parent.
Each run computes the kernel's output at every shape of ``chip_smoke.py``'s
``ATTN_SHAPES`` (causal and not) and ``ATTN_MASK_CASES``, in float32 and
bf16, with p rounded and in float32, from the same numpy inputs
(``chip_smoke.attn_inputs``, seed 0), the backward kernel's (dq, dk, dv)
at every case of ``chip_smoke.ATTN_BWD_CASES`` (the upstream gradient from
seed 1) and, through the autograd wrapper, at every case of
``chip_smoke.MLA_BWD_CASES`` (MLA's (192, 128) and the reduced 24 / 16),
and times the hymba-1.5b serving call (bf16, window 1,024, sink 128, p in
float32), its backward and the bf16 MLA backward at deepseek-v3's training
shape with ``chip_smoke.median_ms``.
Every output must be bit-equal across the four runs, except the bf16
backward at (192, 128), whose kernels differ in sum order between builds:
there each build's two runs must be bit-equal and the parent's and the
change's gradients within ``chip_smoke.RTOL_ATTN_BWD`` of each other
(max|a - b| / max|b|). Outputs compared bit for bit are kept as SHA-256
digests. The script prints each run's times and the comparisons, and exits
1 if one fails.
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


def dump(root: Path, out: Path) -> None:
    """Every output of ``root``'s kernel into ``out`` (``torch.save``)."""
    sys.path.insert(0, str(HERE))
    import chip_smoke as cs                 # puts HERE/src on sys.path
    sys.path.insert(0, str(root / "src"))   # ... and root's ahead of it
    import torch
    from repro_torch.kernels import flash_attention as kflash
    if not Path(kflash.__file__).resolve().is_relative_to(root.resolve()):
        raise SystemExit(f"imported {kflash.__file__}, not {root}'s")
    dev = torch.device("cuda")
    cases = ([(s, causal, None, 0) for s in cs.ATTN_SHAPES
              for causal in (True, False)]
             + [(c[:5], True, c[5], c[6]) for c in cs.ATTN_MASK_CASES])
    outs = {}
    for shape, causal, window, sink in cases:
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = cs.attn_inputs(shape, dtype, 0, dev)
            for round_p in (True, False):
                o = kflash.flash_attention(q, k, v, causal, window=window,
                                           sink=sink, round_p=round_p)
                outs[f"{shape} {dtype} causal={causal} window={window} "
                     f"sink={sink} round_p={round_p}"] = digest(o)
    for B, H, K, S, D, window, sink, dtype in cs.ATTN_BWD_CASES:
        shape, dt = (B, H, K, S, D), getattr(torch, dtype)
        q, k, v = cs.attn_inputs(shape, dt, 0, dev)
        do = cs.attn_inputs(shape, dt, 1, dev)[0]
        o, lse = kflash._forward(q, k, v, True, window, sink, False,
                                 with_lse=True)
        for name, g in zip(("dq", "dk", "dv"), kflash.flash_attention_bwd(
                q, k, v, o, do, lse, True, window, sink)):
            outs[f"bwd {shape} {dtype} window={window} sink={sink} "
                 f"{name}"] = digest(g)
    import numpy as np
    for B, H, K, S, D, Dv, dtype in cs.MLA_BWD_CASES:
        dt = getattr(torch, dtype)
        q, k, v = cs.attn_inputs((B, H, K, S, D, Dv), dt, 0, dev)
        do = torch.from_numpy(np.random.default_rng(1).normal(
            size=(B, H, S, Dv)).astype(np.float32)).to(dev, dt)
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        o = kflash.flash_attention(*leaves, round_p=False)
        for name, g in zip(("dq", "dk", "dv"),
                           torch.autograd.grad(o, leaves, do)):
            # only the bf16 (192, 128) backward changes its sum order
            outs[f"mla {(B, H, K, S, D, Dv)} {dtype} {name}"] = (
                g.cpu() if (D, Dv, dtype) == (192, 128, "bfloat16")
                else digest(g))
        del leaves, o
    B, H, K, S, D, Dv, _ = cs.MLA_BWD_CASES[0]
    q, k, v = cs.attn_inputs((B, H, K, S, D, Dv), torch.bfloat16, 0, dev)
    do = torch.from_numpy(np.random.default_rng(1).normal(
        size=(B, H, S, Dv)).astype(np.float32)).to(dev, torch.bfloat16)
    o, lse = kflash._forward(q, k, v, True, None, 0, False, with_lse=True)
    mla_bwd_ms = cs.median_ms(lambda: kflash.flash_attention_bwd(
        q, k, v, o, do, lse))
    del q, k, v, do, o, lse
    torch.cuda.empty_cache()
    q, k, v = cs.attn_inputs((4, 25, 5, 1128, 64), torch.bfloat16, 0, dev)
    ms = cs.median_ms(lambda: kflash.flash_attention(
        q, k, v, window=1024, sink=128, round_p=False))
    do = cs.attn_inputs((4, 25, 5, 1128, 64), torch.bfloat16, 1, dev)[0]
    o, lse = kflash._forward(q, k, v, True, 1024, 128, False, with_lse=True)
    bwd_ms = cs.median_ms(lambda: kflash.flash_attention_bwd(
        q, k, v, o, do, lse, True, 1024, 128))
    torch.save({"outs": outs, "ms": ms, "bwd_ms": bwd_ms,
                "mla_bwd_ms": mla_bwd_ms}, out)


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
        print(f"{label}: hymba-1.5b (4, 25, 5, 1128, 64) bf16, window 1024, "
              f"sink 128, p float32: forward {r['ms']:.4f} ms, backward "
              f"{r['bwd_ms']:.4f} ms; MLA backward "
              f"{cs.MLA_BWD_CASES[0][:6]} bf16 {r['mla_bwd_ms']:.4f} ms")
    print(f"{len(bit)} outputs compared bit for bit, {len(differ)} differ "
          f"between the four runs")
    for key in differ:
        print(f"  differs: {key}")
    gate = cs.RTOL_ATTN_BWD["bfloat16"]
    failed = list(differ)
    for key in tol:
        same = all(torch.equal(runs[i][1]["outs"][key], runs[j][1]["outs"][key])
                   for i, j in ((0, 3), (1, 2)))
        a, b = change[key].float(), parent[key].float()
        gap = ((a - b).abs().max() / b.abs().max()).item()
        print(f"{key}: each build twice bit-equal {same}, max|change - "
              f"parent| / max|parent| {gap:.3e} (gate {gate})")
        if not same or gap > gate:
            failed.append(key)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
