#!/usr/bin/env python3
"""``chip_smoke.py``'s phase 32 (sharded training on every visible card)
alone, after building the kernels it runs.

    python3 tools/sharded_phase.py [TAG]

Prints what the phase prints and writes its stats, or the gate it failed,
to ``chiprun_out/phase32_<TAG>.json``. Exits 1 if the phase fails. The
workers are started with the ``spawn`` method, which re-imports this file
by path: run it as a file, not from standard input. On four cards:
``chiprun --chips 4 --timeout 600 -- python3 tools/sharded_phase.py 4``.
"""
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke as cs     # noqa: E402  (puts src/ and tests/ on sys.path)

if __name__ == "__main__":
    import torch
    from repro_torch.kernels import build
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, torch.__version__, torch.cuda.device_count(), flush=True)
    t0 = time.perf_counter()
    build.build_libraries(cs.KERNELS)
    for name in cs.KERNELS:
        build.load(name)
    print(f"build {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    stats, err = None, None
    try:
        stats = cs.sharded_phase(0, smi)
    except SystemExit as e:
        err = str(e)
        print(err, flush=True)
    print(f"phase 32 {time.perf_counter() - t0:.1f} s", flush=True)
    tag = sys.argv[1] if len(sys.argv) > 1 else "run"
    out = ROOT / "chiprun_out" / f"phase32_{tag}.json"
    out.parent.mkdir(exist_ok=True)
    out.write_text(json.dumps({"stats": stats, "error": err}, indent=1,
                              default=str))
    sys.exit(0 if err is None else 1)
