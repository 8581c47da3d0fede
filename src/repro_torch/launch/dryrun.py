"""Dry-run records of every (arch x shape x mesh) cell: the reference's
``launch/dryrun.py`` without XLA.

For each cell this writes ``<out>/<arch>__<shape>__<mesh>.json`` with the
reference's keys, so ``launch.roofline`` and ``profiler.traffic`` (of
either package) read it. The reference lowers and compiles each cell on
512 host devices and reads XLA's analyses; the port has no XLA, so it
builds the step's arguments on the meta device (full width, no storage)
and fills the rest from the analytic cost model. Each ``ok`` record says
which field is which under ``"source"``:

- exact against the reference: ``arch``, ``shape``, ``mesh``, ``kind``,
  ``seq_len``, ``global_batch``, ``params_total``, ``params_active``,
  ``model_flops_global`` (6·N·D train, 2·N·D inference) and the skip
  record of ``long_500k``;
- a count: ``memory.argument_bytes``, the global bytes of the step's
  arguments as the reference's ``build_cell`` passes them (train: the
  parameters, the AdamW state, int8 moments for deepseek-v3-671b, the
  batch and the step; prefill: the parameters and the batch; decode: the
  parameters, the ``init_cache(B, S)`` tree and the batch);
- a lower bound: ``memory.peak_bytes_per_device``, that sum split evenly
  over the mesh's chips, with no temporaries;
- analytic: ``cost.flops_per_device`` and ``cost.bytes_per_device``,
  ``roofline.analytic_cost`` over the chips (the reference itself calls
  XLA:CPU's raw counts an undercount);
- not modelled: ``collectives`` (``{}``) and
  ``collective_bytes_per_device`` (0.0), which need the sharding rules of
  multi-card training.

    python -m repro_torch.launch.dryrun --arch qwen3-8b --shape train_4k [--multi-pod]
    python -m repro_torch.launch.dryrun --all [--multi-pod] [--skip-existing] [--dse] [--device cpu]

``--dse`` stamps each ``ok`` record with its heterogeneous L1/L2 memory
pick (``api.explore`` on ``--device``, the card unless ``cpu``).
"""
from __future__ import annotations

import argparse
import json
import sys
import time
import traceback
from pathlib import Path

import torch

from repro_torch.configs import SHAPES, get_config, list_archs
from repro_torch.device import resolve_device
from repro_torch.launch.roofline import analytic_cost, chips_of
from repro_torch.models import LM
from repro_torch.optim.adamw import AdamWConfig, adamw_init

SKIP_REASON = ("full-attention arch; long_500k requires sub-quadratic "
               "attention (DESIGN.md §4)")

# what each field of an ``ok`` record is (module docstring)
SOURCE = {
    "exact": ["arch", "shape", "mesh", "kind", "seq_len", "global_batch",
              "params_total", "params_active", "model_flops_global"],
    "count": ["memory.argument_bytes"],
    "lower_bound": ["memory.peak_bytes_per_device"],
    "analytic": ["cost.flops_per_device", "cost.bytes_per_device"],
    "not_modelled": ["collectives", "collective_bytes_per_device"],
}


def _leaves_with_path(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves_with_path(v, path + (k,))
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _leaves_with_path(v, path + (None,))
    else:
        yield path, tree


def model_flops_params(cfg, params):
    """(N_total, N_active): parameter counts; MoE scales routed experts by
    top_k/num_experts (the ``wg``/``wu``/``wd`` leaves under ``moe`` and
    not under ``shared``)."""
    total = 0
    expert = 0
    for keys, leaf in _leaves_with_path(params):
        n = leaf.numel()
        total += n
        if "moe" in keys and keys[-1] in ("wg", "wu", "wd") \
                and "shared" not in keys:
            expert += n
    if cfg.moe and cfg.num_experts:
        frac = cfg.top_k / cfg.num_experts
        active = total - expert + expert * frac
    else:
        active = total
    return int(total), int(active)


def tree_bytes(tree) -> int:
    """Bytes of a tree's leaves: a tensor's elements times their size, and
    a Python int (the cache's position) as the int32 scalar the reference
    passes in its place."""
    return sum(4 if isinstance(leaf, int) else
               leaf.numel() * leaf.element_size()
               for _, leaf in _leaves_with_path(tree))


def step_arguments(cfg, shape):
    """The arguments of the cell's step, as the reference's ``build_cell``
    passes them, on the meta device: train (params, AdamW state, batch,
    step), prefill (params, batch), decode (params, cache, batch)."""
    lm = LM(cfg, device="meta")
    params = lm.init()
    batch = lm.input_specs(shape)
    if shape.kind == "train":
        acfg = AdamWConfig(quantized=cfg.name == "deepseek-v3-671b")
        step = torch.empty((), dtype=torch.int32, device="meta")
        return params, adamw_init(params, acfg), batch, step
    if shape.kind == "prefill":
        return params, batch
    return params, lm.init_cache(shape.global_batch, shape.seq_len), batch


def run_cell(arch: str, shape_name: str, multi_pod: bool, outdir: Path):
    """Build one cell's record and write it to ``outdir``."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
    out_path = outdir / f"{arch}__{shape_name}__{mesh_name}.json"
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
           "kind": shape.kind, "seq_len": shape.seq_len,
           "global_batch": shape.global_batch}

    if shape.name == "long_500k" and not cfg.supports_long_context:
        rec["status"] = "skipped"
        rec["reason"] = SKIP_REASON
        out_path.write_text(json.dumps(rec, indent=2))
        print(f"[dryrun] SKIP {arch} {shape_name} ({mesh_name})")
        return rec

    t0 = time.perf_counter()
    chips = chips_of(mesh_name)
    args = step_arguments(cfg, shape)
    n_total, n_active = model_flops_params(cfg, args[0])
    arg_bytes = tree_bytes(args)
    rec["memory"] = {"argument_bytes": arg_bytes,
                     "peak_bytes_per_device": arg_bytes / chips}
    ana = analytic_cost(arch, shape_name, n_total, n_active)
    rec["cost"] = {"flops_per_device": ana["flops_global"] / chips,
                   "bytes_per_device": ana["hbm_bytes_global"] / chips}
    rec["collectives"] = {}
    rec["collective_bytes_per_device"] = 0.0
    tokens = shape.global_batch * (shape.seq_len if shape.kind in
                                   ("train", "prefill") else 1)
    mult = 6 if shape.kind == "train" else 2
    rec["params_total"] = n_total
    rec["params_active"] = n_active
    rec["model_flops_global"] = mult * n_active * tokens
    rec["timing"] = {"build_s": round(time.perf_counter() - t0, 2)}
    rec["source"] = SOURCE
    rec["status"] = "ok"
    out_path.write_text(json.dumps(rec, indent=2))
    print(f"[dryrun] OK {arch} {shape_name} ({mesh_name}) "
          f"flops/dev={rec['cost']['flops_per_device']:.3g} "
          f"args/dev={rec['memory']['peak_bytes_per_device'] / 2**30:.2f}GiB")
    return rec


def memory_dse_annotate(cells, outdir: Path, device=None):
    """One ``repro_torch.api.explore`` call (on ``device``, None = the
    card) over every ``ok`` cell: derive the GainSight-analog L1/L2
    requirements from each record and stamp the selected heterogeneous
    memory mix back into its JSON. Returns the report (None if no cell
    is ``ok``)."""
    from repro_torch.api import SelectionPolicy, explore
    from repro_torch.profiler.traffic import arch_task

    tasks, paths = [], {}
    for rec, out_path in cells:
        if rec.get("status") != "ok":
            continue
        t = arch_task(rec["arch"], rec["shape"], rec)
        tasks.append(t)
        paths[t.task_id] = (rec, out_path)
    if not tasks:
        return None
    report = explore(tasks=tasks,
                     policy=SelectionPolicy(allow_refresh=True),
                     cache=outdir / "dse_cache", device=device)
    for tid, levels in report.labels().items():
        rec, out_path = paths[tid]
        rec["memory_dse"] = levels
        out_path.write_text(json.dumps(rec, indent=2))
        print(f"[dryrun] DSE {tid}: L1={levels['L1']} L2={levels['L2']}")
    return report


def main(argv=None) -> int:
    """The command line; returns the exit code (1 if a cell failed)."""
    ap = argparse.ArgumentParser(description="dry-run records of the cells")
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--dse", action="store_true",
                    help="annotate each record with its heterogeneous "
                         "L1/L2 memory pick (repro_torch.api.explore)")
    ap.add_argument("--out", default="artifacts/dryrun")
    ap.add_argument("--device", default=None,
                    help="where --dse characterizes (default: the card)")
    args = ap.parse_args(argv)
    if not args.all and not (args.arch and args.shape):
        ap.error("give --arch and --shape, or --all")
    device = resolve_device(args.device)
    outdir = Path(args.out)
    outdir.mkdir(parents=True, exist_ok=True)

    if args.all:
        cells = [(arch, shape) for arch in list_archs() for shape in SHAPES]
    else:
        cells = [(args.arch, args.shape)]

    mesh_name = "pod2x16x16" if args.multi_pod else "pod16x16"
    failures = 0
    done = []
    for arch, shape in cells:
        out_path = outdir / f"{arch}__{shape}__{mesh_name}.json"
        if args.skip_existing and out_path.exists():
            rec = json.loads(out_path.read_text())
            if rec.get("status") in ("ok", "skipped"):
                done.append((rec, out_path))
                continue
        try:
            rec = run_cell(arch, shape, args.multi_pod, outdir)
            done.append((rec, out_path))
        except Exception as e:  # record the failure, keep sweeping
            failures += 1
            rec = {"arch": arch, "shape": shape, "mesh": mesh_name,
                   "status": "error", "error": repr(e),
                   "traceback": traceback.format_exc()[-4000:]}
            out_path.write_text(json.dumps(rec, indent=2))
            print(f"[dryrun] FAIL {arch} {shape} ({mesh_name}): {e!r}")
    if args.dse:
        memory_dse_annotate(done, outdir, device=device)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
