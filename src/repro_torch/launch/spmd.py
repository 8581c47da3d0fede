"""Multi-process runs of the sharded paths.

``launch(fn, nprocs, args)`` starts ``nprocs`` worker processes (the
``spawn`` method), one per card on the card (``cuda:<rank>``, NCCL) or on
the CPU (gloo) when ``device="cpu"``; each joins one process group through
a ``file://`` store in a fresh directory (under ``store_dir`` when given),
so runs never share a port, and calls ``fn(*args)``. It returns the ranks'
results in rank order, and raises if a worker raises, dies or outlives
``timeout`` (then every worker is killed): a hung collective fails the run
instead of stalling it. ``fn`` must be importable by name (a module-level
function) in the workers, which start with the caller's ``sys.path``.
``run_all(checks)`` runs several ``(fn, spec)`` in one launch, in order.
"""
from __future__ import annotations

import datetime
import os
import queue as queue_mod
import tempfile
import time
import traceback
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch
import torch.distributed as dist
import torch.multiprocessing as mp



# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------


def _worker(rank, world, store, device, fn, args, env, timeout, out_q):
    try:
        os.environ.update(env)
        kw = {}
        if device == "cpu":         # the ranks share the host's cores
            torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
        if device == "cuda":
            torch.cuda.set_device(rank % torch.cuda.device_count())
            kw["device_id"] = torch.device("cuda", torch.cuda.current_device())
        dist.init_process_group(
            "nccl" if device == "cuda" else "gloo",
            init_method=f"file://{store}", rank=rank, world_size=world,
            timeout=datetime.timedelta(seconds=timeout), **kw)
        result = fn(*args)
        out_q.put((rank, "ok", result))
    except BaseException:           # reported to the parent, which raises
        out_q.put((rank, "error", traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def launch(fn: Callable, nprocs: int, args: Sequence = (), *,
           device: str = "cuda", timeout: float = 300.0,
           env: Optional[Dict[str, str]] = None,
           store_dir: Optional[str] = None) -> List[Any]:
    """``fn(*args)`` on ``nprocs`` ranks (module docstring). Returns their
    results in rank order."""
    if device not in ("cuda", "cpu"):
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    if device == "cuda" and torch.cuda.device_count() < nprocs:
        raise RuntimeError(f"{nprocs} workers need {nprocs} cards, "
                           f"{torch.cuda.device_count()} are visible")
    ctx = mp.get_context("spawn")
    store = os.path.join(tempfile.mkdtemp(dir=store_dir), "store")
    out_q = ctx.Queue()
    procs = [ctx.Process(target=_worker, daemon=True,
                         args=(r, nprocs, store, device, fn, tuple(args),
                               dict(env or {}), timeout, out_q))
             for r in range(nprocs)]
    for p in procs:
        p.start()
    results: Dict[int, Any] = {}
    deadline = time.monotonic() + timeout
    try:
        while len(results) < nprocs:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"{fn.__name__} on {nprocs} ranks did not "
                                   f"finish in {timeout:.0f} s (ranks done: "
                                   f"{sorted(results)})")
            try:
                rank, status, payload = out_q.get(timeout=min(left, 5.0))
            except queue_mod.Empty:
                dead = [r for r, p in enumerate(procs)
                        if not p.is_alive() and r not in results]
                if dead:
                    raise RuntimeError(f"{fn.__name__}: ranks {dead} exited "
                                       f"without a result")
                continue
            if status == "error":
                raise RuntimeError(f"{fn.__name__} failed on rank {rank}:\n"
                                   f"{payload}")
            results[rank] = payload
    finally:
        for p in procs:
            p.join(timeout=30)
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
    return [results[r] for r in range(nprocs)]


def run_all(checks: Sequence) -> List[Any]:
    """Each ``(fn, spec)`` of ``checks`` in turn on this rank: their
    results."""
    return [fn(spec) for fn, spec in checks]
