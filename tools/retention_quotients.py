#!/usr/bin/env python3
"""Check the retention kernel's correctly rounded quotients.

``kernels/csrc/retention.cu`` forms u1 = -vt_eff / (n UT) and dV/dt =
-leak / c from per-row reciprocals with Markstein's correction
(``div_by``) instead of IEEE division. This script checks that claim:

    python3 tools/retention_quotients.py --numpy [--count 80000000]
        on the CPU: Markstein's correction of float32 quotients from
        correctly rounded reciprocals, the fused multiply-adds emulated in
        float64, against IEEE float32 division, on random operands over the
        kernel's ranges; prints the number that differ.

    python3 tools/retention_quotients.py [--seed 0]
        on one CUDA device: builds the shipped source and a variant of it
        whose ``div_by(x, y, r)`` is ``__fdiv_rn(x, y)`` (div.rn), runs both
        on the paper grid, the wide grid and two sets of 2^20 perturbed rows
        packed at nominal, hot, cold, low_vdd and (1.2 V, 233 K), counts the
        outputs that differ, and times both in turns (shipped, div.rn,
        div.rn, shipped) with CUDA events.

Exits non-zero if any quotient or output differs.
"""
from __future__ import annotations

import argparse
import ctypes
import re
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

CORNERS = ("nominal", "hot", "cold", "low_vdd", (1.2, 233.0))


def numpy_check(count: int, seed: int) -> int:
    """Markstein quotients against IEEE float32 division; returns the
    number that differ. x spans the kernel's numerators (|vt_eff| ~ 0.1-1,
    |leak| down to 1e-30), y its denominators (n UT ~ 0.02-0.05, c_sn
    ~ 1e-18-1e-14), both well beyond."""
    import numpy as np
    f32, f64 = np.float32, np.float64

    def fma(a, b, c):
        return (a.astype(f64) * b.astype(f64) + c.astype(f64)).astype(f32)

    rng = np.random.default_rng(seed)
    differ, done, batch = 0, 0, 2_000_000
    while done < count:
        n = min(batch, count - done)
        x = (rng.uniform(0.5, 1.0, n) * 10.0 ** rng.uniform(-30, 2, n)
             * rng.choice([-1.0, 1.0], n)).astype(f32)
        y = (rng.uniform(0.5, 1.0, n) * 10.0 ** rng.uniform(-18, 1, n)
             ).astype(f32)
        r = f32(1.0) / y
        q = x * r
        differ += int((fma(fma(-q, y, x), r, q) != x / y).sum())
        done += n
    print(f"numpy: {differ} of {count} Markstein quotients differ from "
          f"IEEE float32 division")
    return differ


def build_variants(tmp: Path):
    """The shipped library and its div.rn variant, with their launch
    functions declared."""
    from repro_torch.kernels import build
    src = (build.CSRC / "retention.cu").read_text()
    variant, n = re.subn(r"div_by\(([^;]*?), ([\w.]+), ([\w.]+)\)",
                         r"__fdiv_rn(\1, \2)", src)
    if n != 2:
        raise SystemExit(f"expected 2 div_by calls in retention.cu, got {n}")
    (tmp / "retention_divrn.cu").write_text(variant)
    libs = {}
    for name, path in (("shipped", build.CSRC / "retention.cu"),
                       ("div.rn", tmp / "retention_divrn.cu")):
        so = tmp / f"{name.replace('.', '')}.so"
        run = subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-o", str(so),
                              str(path)], capture_output=True, text=True)
        if run.returncode != 0:
            raise SystemExit(f"nvcc failed on {path}:\n{run.stderr}")
        regs = [ln.split("info    : ")[-1] for ln in run.stderr.splitlines()
                if "registers" in ln]
        print(f"build {name}: {regs}")
        fn = getattr(ctypes.CDLL(str(so)), "retention_launch")
        fn.argtypes = build.LAUNCH_ARGTYPES["retention"]
        fn.restype = ctypes.c_int
        libs[name] = fn
    return libs


def card_check(seed: int) -> int:
    import torch

    import chip_smoke
    from repro_torch import api
    from repro_torch.core import bitcells, corners, retention
    from repro_torch.kernels.retention import thermal_voltage_args
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    dev = torch.device("cuda")
    ts = retention.time_grid(dev)
    print(torch.cuda.get_device_name(0), subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip())

    def packed(space, tp):
        cells = bitcells.take_bitcell(
            bitcells.stack_bitcells().to(dev),
            torch.tensor([bitcells.MEM_TYPE[c.mem_type] for c in space],
                         device=dev))
        ls = torch.tensor([float(c.level_shift) for c in space], device=dev)
        return retention.pack_retention_params(cells, ls, tp)

    wide = api.design_space(
        mem_types=tuple(bitcells.BITCELLS),
        word_sizes=(8, 16, 32, 64, 128, 256),
        num_words=tuple(2 ** k for k in range(4, 13)), banks=(1, 2, 4, 8),
        ls_options=(False, True))
    differ = 0
    with tempfile.TemporaryDirectory() as tmp:
        libs = build_variants(Path(tmp))

        def launch(name, params, ut):
            out = torch.empty(params.shape[0], device=dev)
            params_t = params.t().contiguous()
            ut32, inv_ut = thermal_voltage_args(ut)
            err = libs[name](params_t.data_ptr(), ts.data_ptr(),
                             out.data_ptr(), params.shape[0],
                             ts.shape[0] - 1, ut32, inv_ut,
                             torch.cuda.current_stream().cuda_stream)
            if err != 0:
                raise SystemExit(f"{name} launch failed: cudaError {err}")
            return out

        for op in CORNERS:
            point = corners.as_operating_point(op)
            tp = corners.TechParams.from_op(point)
            base = torch.cat([retention.pack_retention_params(
                bitcells.stack_bitcells().to(dev),
                torch.full((7,), float(ls), device=dev), tp)
                for ls in (0, 1)])
            sets = {"120": packed(api.design_space(), tp),
                    "2808": packed(wide, tp),
                    "2^20": chip_smoke.perturbed_rows(base, 1 << 20, seed),
                    "2^20'": chip_smoke.perturbed_rows(base, 1 << 20,
                                                       seed + 1)}
            for label, params in sets.items():
                a = launch("shipped", params, tp.ut)
                b = launch("div.rn", params, tp.ut)
                torch.cuda.synchronize()
                n_diff = int((a != b).sum())
                differ += n_diff
                iters = 200 if params.shape[0] < 10_000 else 20
                ms = {}
                for name in ("shipped", "div.rn", "div.rn", "shipped"):
                    ms.setdefault(name, []).append(chip_smoke.time_ms(
                        lambda: launch(name, params, tp.ut), iters, 3))
                print(f"{point.corner} B={label}: {n_diff} outputs differ; "
                      f"shipped {ms['shipped'][0]:.4f}, "
                      f"{ms['shipped'][1]:.4f} ms; div.rn "
                      f"{ms['div.rn'][0]:.4f}, {ms['div.rn'][1]:.4f} ms",
                      flush=True)
    print(f"card: {differ} outputs differ in all")
    return differ


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--numpy", action="store_true",
                        help="the CPU check of the arithmetic alone")
    parser.add_argument("--count", type=int, default=80_000_000)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    if args.numpy:
        return 1 if numpy_check(args.count, args.seed) else 0
    return 1 if card_check(args.seed) else 0


if __name__ == "__main__":
    sys.exit(main())
