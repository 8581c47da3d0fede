#!/usr/bin/env python3
"""The flash-attention forward kernel of two checkouts, bit for bit, on the
card.

    python3 tools/attention_builds.py PARENT_ROOT CHANGE_ROOT

Each checkout's kernel is built from its own sources (into its own
``build/repro_torch/``) and run in a process of its own, importing that
checkout's ``repro_torch``, in the order parent, change, change, parent.
Each run computes the kernel's output at every shape of ``chip_smoke.py``'s
``ATTN_SHAPES`` (causal and not) and ``ATTN_MASK_CASES``, in float32 and
bf16, with p rounded and in float32, from the same numpy inputs
(``chip_smoke.attn_inputs``, seed 0), and times the hymba-1.5b serving
call (bf16, window 1,024, sink 128, p in float32) with
``chip_smoke.median_ms``. The script prints each run's time and whether
every output is bit-equal across the four runs; it exits 1 if one is not.
It needs one CUDA device and ``nvcc``.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
import tempfile
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]


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
                     f"sink={sink} round_p={round_p}"] = o.cpu()
    q, k, v = cs.attn_inputs((4, 25, 5, 1128, 64), torch.bfloat16, 0, dev)
    ms = cs.median_ms(lambda: kflash.flash_attention(
        q, k, v, window=1024, sink=128, round_p=False))
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
    runs = []
    with tempfile.TemporaryDirectory() as tmp:
        for i, (label, root) in enumerate(
                (("parent", args.roots[0]), ("change", args.roots[1]),
                 ("change", args.roots[1]), ("parent", args.roots[0]))):
            out = Path(tmp) / f"run{i}.pt"
            subprocess.run([sys.executable, __file__, str(root), str(root),
                            "--dump", str(out)], check=True)
            runs.append((label, torch.load(out)))
    ref = runs[0][1]["outs"]
    differ = sorted({key for _, r in runs[1:] for key, o in r["outs"].items()
                     if not torch.equal(o, ref[key])})
    for label, r in runs:
        print(f"{label}: hymba-1.5b serving call (4, 25, 5, 1128, 64) bf16, "
              f"window 1024, sink 128, p float32: {r['ms']:.4f} ms")
    print(f"{len(ref)} outputs, {len(differ)} differ between the four runs")
    for key in differ:
        print(f"  differs: {key}")
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main())
