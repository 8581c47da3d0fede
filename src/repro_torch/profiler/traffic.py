"""GainSight-analog profiler for the 10 registered architectures: the
reference's ``profiler/traffic.py``.

The paper profiles GPU workloads (Table 1) for L1/L2 read-frequency and
data-lifetime needs, then lets the compiler pick memory technologies. Here
the same is done for a TPU-v5e-like accelerator running the registered
architectures: per-tensor-class traffic and lifetimes are derived from the
dry-run records (``launch.dryrun``, ``artifacts/dryrun/*.json``) and the
architecture configs, and fed to the same DSE. The hardware constants are
that accelerator's, the one the DSE designs for; they are not the H100's.

Tensor classes ("buckets" in DSE terms):
  weights      — read-mostly, long-lived (inference) / step-lived (training)
  activations  — produced+consumed within ~one layer time: microsecond-lived
  kv_cache     — write-once read-many across a decode session: second-lived
  accumulators — latency-critical running state (flash-attention m/l, MXU
                 accumulators): must run at core speed
"""
from __future__ import annotations

import json
import warnings
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple, Union

from repro_torch.configs import SHAPES, get_config
from repro_torch.core.select import Bucket, LevelReq, TaskReq
from repro_torch.launch.roofline import HBM_BW, LINK_BW, PEAK_FLOPS

# dry-run shape kind -> simulator phase envelope (repro_torch.sim.trace.PHASES)
_KIND_TO_PHASE = {"train": "train_step", "prefill": "prefill",
                  "decode": "decode"}

# TPU-v5e-like hardware constants (the peaks are the roofline's)
CORE_CLOCK_HZ = 0.94e9        # v5e-class core clock
L1_ANALOG_BITS = 8 * (1 << 20)      # ~1 MiB tile/operand buffers
L2_ANALOG_BITS = 8 * (64 << 20)     # ~64 MiB on-chip staging (CMEM-class)


def load_dryrun_record(arch: str, shape: str, mesh: str = "pod16x16",
                       outdir: str = "artifacts/dryrun") -> Optional[dict]:
    """The cell's record under ``outdir``; None if it is missing or not
    ``ok``."""
    p = Path(outdir) / f"{arch}__{shape}__{mesh}.json"
    if not p.exists():
        return None
    rec = json.loads(p.read_text())
    return rec if rec.get("status") == "ok" else None


def step_time_estimate(rec: dict) -> float:
    """Roofline-style lower bound on the step time from the dry-run record."""
    t_c = rec["cost"]["flops_per_device"] / PEAK_FLOPS
    t_m = rec["cost"]["bytes_per_device"] / HBM_BW
    t_l = rec["collective_bytes_per_device"] / LINK_BW
    return max(t_c, t_m, t_l, 1e-9)


def arch_requirements(arch: str, shape_name: str,
                      rec: Optional[dict] = None) -> Dict[str, LevelReq]:
    """Per-tensor-class memory requirements for one (arch x shape) cell."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    rec = rec or load_dryrun_record(arch, shape_name)
    if rec is None:
        raise FileNotFoundError(f"no dry-run record for {arch} {shape_name}")
    t_step = step_time_estimate(rec)
    layers = max(cfg.num_layers, 1)

    # lifetimes ------------------------------------------------------------
    act_lifetime = max(t_step / layers, 1e-7)
    if shape.kind == "train":
        # residuals live from forward until their backward layer
        act_lifetime = max(t_step, 1e-6)
        weight_lifetime = t_step          # overwritten by the optimizer
    else:
        weight_lifetime = 3600.0          # serving session scale
    kv_lifetime = shape.seq_len * t_step if shape.kind == "decode" else t_step

    # read frequencies -------------------------------------------------------
    # operand buffers feed the MXU every cycle; staging buffers sustain the
    # HBM-side stream for this cell
    f_l1 = CORE_CLOCK_HZ
    words_per_step = rec["cost"]["bytes_per_device"] / 64.0   # 512-bit lines
    f_l2 = min(words_per_step / t_step, 3.0e9)

    l1 = LevelReq("L1", L1_ANALOG_BITS, (
        Bucket(0.7, f_l1, act_lifetime),          # operands/accumulators
        Bucket(0.3, f_l1, act_lifetime),          # spilled partials
    ))
    moe_frac = (cfg.top_k / cfg.num_experts) if cfg.moe else 1.0
    l2_buckets = [
        Bucket(0.45, f_l2, act_lifetime),                     # activations
        Bucket(0.35, f_l2 * moe_frac * 0.5, weight_lifetime),  # weight stream
    ]
    if shape.kind == "decode":
        l2_buckets.append(Bucket(0.20, f_l2 * 0.5, kv_lifetime))
    else:
        l2_buckets.append(Bucket(0.20, f_l2, act_lifetime))
    l2 = LevelReq("L2", L2_ANALOG_BITS, tuple(l2_buckets))
    return {"L1": l1, "L2": l2, "t_step": t_step}


def arch_task(arch: str, shape_name: str,
              rec: Optional[dict] = None) -> TaskReq:
    """One (arch x shape) cell as a TaskReq for ``repro_torch.api.explore``
    or ``repro_torch.api.Compiler.compose`` (both consume the same normal
    form)."""
    reqs = arch_requirements(arch, shape_name, rec)
    return TaskReq(task_id=f"{arch}/{shape_name}",
                   name=f"{arch} {shape_name}",
                   levels={"L1": reqs["L1"], "L2": reqs["L2"]})


def available_arch_tasks(
    shapes: Sequence[str] = ("train_4k", "decode_32k"),
    archs: Optional[Sequence[str]] = None,
    mesh: str = "pod16x16",
    outdir: str = "artifacts/dryrun",
    return_missing: bool = False,
) -> Union[List[TaskReq], Tuple[List[TaskReq], List[Tuple[str, str]]]]:
    """Every (arch x shape) cell with a clean dry-run record, as TaskReqs.

    This is the profiler-side requirements source for the composition engine
    (the GainSight paper tasks in ``repro_torch.core.gainsight`` are the
    other). ``mesh`` selects which dry-run mesh's records to read
    (``"pod2x16x16"`` for ``--multi-pod`` runs). A checkout without
    ``artifacts/dryrun`` gets an empty list, so callers degrade gracefully
    instead of raising, but never silently: when every requested cell is
    missing, a ``RuntimeWarning`` names the record directory and the
    generator command, and ``return_missing=True`` returns ``(tasks,
    missing)`` where ``missing`` lists the (arch, shape) cells that had no
    clean record.
    """
    from repro_torch.configs import ALL_ARCHS
    tasks: List[TaskReq] = []
    missing: List[Tuple[str, str]] = []
    for arch in (archs if archs is not None else ALL_ARCHS):
        for shape in shapes:
            rec = load_dryrun_record(arch, shape, mesh=mesh, outdir=outdir)
            if rec is not None:
                tasks.append(arch_task(arch, shape, rec))
            else:
                missing.append((arch, shape))
    if missing and not tasks:
        warnings.warn(
            f"no clean dry-run records under {outdir!r} for mesh {mesh!r} "
            f"({len(missing)} (arch, shape) cells missing; generate them "
            f"with `python -m repro_torch.launch.dryrun --all`)",
            RuntimeWarning, stacklevel=2)
    if return_missing:
        return tasks, missing
    return tasks


def arch_traces(arch: str, shape_name: str, rec: Optional[dict] = None,
                n_bins: int = 32, n_steps: int = 4, mesh: str = "pod16x16",
                outdir: str = "artifacts/dryrun"):
    """Dry-run-derived time-binned traces for one (arch x shape) cell.

    The trace export of the profiler: the cell's requirements
    (``arch_task``) are binned by ``repro_torch.sim.trace`` with the phase
    envelope matching the dry-run shape's kind (train -> train_step,
    prefill/decode as themselves) over a window of ``n_steps`` roofline
    step times, so the simulator replays the same step the analytic
    requirements were priced from. ``mesh``/``outdir`` select the record
    set like ``available_arch_tasks``. Returns a 1-tuple of
    ``repro_torch.sim.trace.Trace``.
    """
    from repro_torch.sim.trace import task_traces
    rec = rec or load_dryrun_record(arch, shape_name, mesh=mesh,
                                    outdir=outdir)
    if rec is None:
        raise FileNotFoundError(f"no dry-run record for {arch} {shape_name} "
                                f"({mesh}) under {outdir}")
    task = arch_task(arch, shape_name, rec)
    phase = _KIND_TO_PHASE[SHAPES[shape_name].kind]
    duration = max(step_time_estimate(rec), 1e-6) * n_steps
    return task_traces(task, phases=(phase,), duration_s=duration,
                       n_bins=n_bins)
