#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0]

Run from the root of a checkout; it needs one CUDA device and ``nvcc``.
Phases, each of which fails the run (non-zero exit) if its check fails:

1. device   name, count, and ``nvidia-smi`` name and power limit;
2. build    the retention kernel from ``kernels/csrc/retention.cu``;
3. kernel   against its plain PyTorch version on the card at B = 14 (the
            packed nominal rows: 7 bitcells x level shifter), 130 (ragged)
            and 2^20 (rows perturbed from ``--seed``), rtol 1e-5; rows that
            start crossed must agree exactly;
4. main     ``explore(device="cuda")`` on the paper grid: Table 2 at 7/7,
            through the kernel (launch count > 0), metric columns equal to
            the CPU build of the same table within ``RTOL_CPU``;
5. wide     ``DesignTable.build`` of the 2,808-config grid on the card:
            every value finite;
6. timing   kernel and plain version with CUDA events at B = 120 (the main
            path's shape) and 2^20, beside the kernel's bound;
7. profile  one warm ``explore`` under ``torch.profiler``: device busy time
            and share, and the kernels that take it.

It prints one ``{"kernels": [...]}`` line, then, last, the
``{"ok": true, "device": {...}}`` line.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

RTOL_KERNEL = 1e-5      # kernel vs plain version (the Pallas kernel's gate)
RTOL_CPU = 2e-6         # table on the card vs the same table on the CPU
PEAK_FP32_OPS = 67e12   # H100 SXM fp32 outside the tensor cores [op/s]
PEAK_BYTES = 3.35e12    # H100 SXM HBM3 [B/s]
# fp32 operations per row per RK4 step, counted from retention.cu: four
# derivative evaluations of 26 arithmetic ops (3 of them divisions) and 4
# transcendental calls each (2 expf, 2 log1pf), plus 21 ops for dt, the
# stage inputs, the update, the clip and the crossing test. Each division
# and transcendental call counts as one operation, so the bound is a least
# time. The crossing step adds 9 ops and 3 transcendentals once per row.
OPS_PER_STEP = 4 * (26 + 4) + 21
OPS_PER_CROSSING = 9 + 3


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def nominal_rows(device):
    """(14, 10) packed kernel rows of the 7 bitcells x level shifter."""
    import torch
    from repro_torch.core import bitcells, retention
    cells = bitcells.stack_bitcells().to(device)
    return torch.cat([retention.pack_retention_params(
        cells, torch.full((7,), float(ls), device=device)) for ls in (0, 1)])


def perturbed_rows(base, n: int, seed: int):
    """``n`` rows drawn from ``base`` with log-uniform factors in
    [0.1, 10] on ispec, i_floor, c_sn and w, and vt shifted by up to
    +-50 mV."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    b = base.cpu().numpy().astype(np.float64)
    p = b[rng.integers(0, b.shape[0], n)]
    for field in (2, 4, 6, 7):
        p[:, field] *= 10.0 ** rng.uniform(-1.0, 1.0, n)
    p[:, 0] += rng.uniform(-0.05, 0.05, n)
    return torch.from_numpy(p.astype(np.float32)).to(base.device)


def compare_kernel(params, ts):
    """Kernel vs plain version on the same inputs; returns (max abs err,
    max rel err)."""
    import torch
    from repro_torch.kernels import ref, retention
    got = retention.retention_batch(params, ts)
    want = ref.retention_ref(params, ts)
    torch.cuda.synchronize()
    if not torch.isfinite(got).all():
        fail(f"kernel output not finite at B={params.shape[0]}")
    abs_err = (got - want).abs()
    rel_err = (abs_err / want.abs()).max().item()
    if rel_err > RTOL_KERNEL:
        fail(f"kernel vs plain at B={params.shape[0]}: max rel err "
             f"{rel_err:.3e} > {RTOL_KERNEL}")
    start_crossed = params[:, 8] < params[:, 9]
    if not torch.equal(got[start_crossed], want[start_crossed]):
        fail(f"start-crossed rows differ at B={params.shape[0]}")
    print(f"kernel B={params.shape[0]}: max rel err {rel_err:.3e}, max abs "
          f"err {abs_err.max().item():.3e} s, start-crossed rows "
          f"{int(start_crossed.sum())} exact", flush=True)
    return abs_err.max().item(), rel_err


def time_ms(fn, iters: int, warmup: int) -> float:
    """Mean ms per call of ``fn`` over ``iters`` calls, CUDA events."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(params, ts, out):
    """(bound ms, 'bytes' | 'operations') of one launch on these inputs."""
    B, n_steps = params.shape[0], ts.shape[0] - 1
    crossed = int(((out < ts[-1]) & (params[:, 8] >= params[:, 9])).sum())
    ops = B * n_steps * OPS_PER_STEP + crossed * OPS_PER_CROSSING
    nbytes = params.numel() * 4 + ts.numel() * 4 + B * 4
    t_ops, t_bytes = ops / PEAK_FP32_OPS, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, default=0,
                        help="seed of the perturbed kernel rows")
    args = parser.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import numpy as np
    from repro_torch import api
    from repro_torch.core import bitcells, gainsight, retention
    from repro_torch.kernels import build, ref
    from repro_torch.kernels import retention as kretention

    # 1. device --------------------------------------------------------------
    dev = torch.device("cuda")
    kind, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(f"device: {kind} x{count}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}")
    print(smi, flush=True)

    # 2. build ---------------------------------------------------------------
    t0 = time.perf_counter()
    build.load_retention()
    print(f"build: retention kernel in {time.perf_counter() - t0:.2f} s")
    print(build.build_library("retention").with_suffix(".log").read_text(),
          flush=True)

    # 3. kernel vs plain -----------------------------------------------------
    ts = retention.time_grid(dev)
    base = nominal_rows(dev)
    errs = [compare_kernel(p, ts) for p in
            (base, perturbed_rows(base, 130, args.seed),
             perturbed_rows(base, 1 << 20, args.seed))]
    max_abs_err = max(e[0] for e in errs)
    max_rel_err = max(e[1] for e in errs)

    # 4. main path -----------------------------------------------------------
    kretention.retention_batch.launches = 0
    t0 = time.perf_counter()
    report = api.explore(device="cuda")
    torch.cuda.synchronize()
    explore_s = time.perf_counter() - t0
    launches = kretention.retention_batch.launches
    labels = report.labels()
    print(report.summary())
    if labels != gainsight.TABLE2_EXPECTED:
        fail(f"Table 2 on the card: {report.matches(gainsight.TABLE2_EXPECTED)}"
             f"/7, labels {labels}")
    if launches == 0:
        fail("explore(device='cuda') did not launch the retention kernel")
    t0 = time.perf_counter()
    api.explore(device="cuda")
    torch.cuda.synchronize()
    explore_warm_s = time.perf_counter() - t0
    cpu_table = api.DesignTable.build(device="cpu")
    worst = 0.0
    for name in cpu_table.metric_names:
        a = np.asarray(report.table[name], np.float64)
        b = np.asarray(cpu_table[name], np.float64)
        rel = np.abs(a - b) / np.maximum(np.abs(b), np.finfo(np.float64).tiny)
        worst = max(worst, float(rel.max()))
        if not np.allclose(a, b, rtol=RTOL_CPU, atol=0.0):
            fail(f"column {name}: card vs CPU max rel {rel.max():.3e} > "
                 f"{RTOL_CPU}")
    print(f"main: explore(device='cuda') Table 2 7/7, {launches} kernel "
          f"launch(es), {len(report.table)} configs, card vs CPU max rel "
          f"{worst:.3e}; explore {explore_s:.4f} s first, "
          f"{explore_warm_s:.4f} s warm", flush=True)

    # 5. wide grid -----------------------------------------------------------
    wide = api.design_space(mem_types=tuple(bitcells.BITCELLS),
                            word_sizes=(8, 16, 32, 64, 128, 256),
                            num_words=tuple(2 ** k for k in range(4, 13)),
                            banks=(1, 2, 4, 8), ls_options=(False, True))
    t0 = time.perf_counter()
    wide_table = api.DesignTable.build(wide, device="cuda")
    torch.cuda.synchronize()
    wide_s = time.perf_counter() - t0
    bad = [k for k in wide_table.metric_names
           if not np.isfinite(wide_table[k]).all()]
    if len(wide_table) != 2808 or bad:
        fail(f"wide grid: {len(wide_table)} rows, non-finite columns {bad}")
    print(f"wide: {len(wide_table)} configs characterized on the card in "
          f"{wide_s:.4f} s, all finite", flush=True)

    # 6. timing --------------------------------------------------------------
    cells = bitcells.take_bitcell(
        bitcells.stack_bitcells().to(dev),
        torch.tensor([bitcells.MEM_TYPE[m] for m in report.table["mem_type"]],
                     device=dev))
    main_rows = retention.pack_retention_params(
        cells, torch.tensor(report.table["level_shift"], dtype=torch.float32,
                            device=dev))
    shapes = {}
    for label, params, k_iters, p_iters in (
            ("main", main_rows, 200, 3),
            ("2^20", perturbed_rows(base, 1 << 20, args.seed), 20, 2)):
        out = kretention.retention_batch(params, ts)
        ms = time_ms(lambda: kretention.retention_batch(params, ts),
                     k_iters, warmup=3)
        plain_ms = time_ms(lambda: ref.retention_ref(params, ts),
                           p_iters, warmup=1)
        bound_ms, bound_by = bound(params, ts, out)
        shapes[label] = {"B": params.shape[0], "ms": ms,
                         "plain_ms": plain_ms, "bound_ms": bound_ms,
                         "bound_by": bound_by}
        print(f"timing B={params.shape[0]}: kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by})",
              flush=True)

    # 7. where a warm explore's time goes ----------------------------------
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        api.explore(device="cuda")
        torch.cuda.synchronize()
        profiled_s = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages() if e.self_device_time_total > 0]
    device_us = sum(e.self_device_time_total for e in kernels)
    print(f"profile: warm explore {profiled_s:.4f} s wall, device busy "
          f"{device_us / 1e3:.4f} ms ({device_us / 1e4 / profiled_s:.2f} %) "
          f"in {sum(e.count for e in kernels)} kernel launches")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:5]:
        print(f"  {e.self_device_time_total / 1e3:9.4f} ms  x{e.count:<5d} "
              f"{e.key[:90]}")

    main_shape = shapes["main"]
    print(f"end-to-end: explore(device='cuda') {explore_s:.4f} s (first "
          f"call), {explore_warm_s:.4f} s (warm); {smi}")
    print(json.dumps({"kernels": [{
        "name": "retention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/retention.cu",
        "replaces": "src/repro/kernels/retention_kernel.py:68",
        "launches": launches, "max_abs_err": max_abs_err,
        "max_rel_err": max_rel_err, "rtol": RTOL_KERNEL,
        "ms": main_shape["ms"], "plain_ms": main_shape["plain_ms"],
        "bound_ms": main_shape["bound_ms"],
        "bound_by": main_shape["bound_by"], "library_ms": None,
        "shapes": shapes}]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
