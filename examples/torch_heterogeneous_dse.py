"""Heterogeneous memory design-space exploration through the PyTorch
port's ``repro_torch.hetero``, as ``examples/heterogeneous_dse.py`` does it
through the JAX package: ``Compiler.compose`` scores every joint (L1 tech,
L2 tech) system design per task and prints the full composition report —
Table-2 labels (7 x "OK"), per-bucket macro picks + tiling, and system
area/power/bandwidth. The beyond-paper extras (Pareto front, gradient
sizing) ride on the same ``DesignTable``.

Runs on the CUDA device unless ``--device cpu`` is given (without a card
the default raises); the table cache goes under ``--cache``::

    PYTHONPATH=src python examples/torch_heterogeneous_dse.py [--device cpu] [--cache DIR]
"""
import argparse

from repro_torch.api import Compiler, ComposePolicy, MacroConfig
from repro_torch.core import gainsight


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    ap.add_argument("--cache", default="artifacts/dse_cache",
                    help="directory of the table and composition caches")
    args = ap.parse_args(argv)
    cache = args.cache

    compiler = Compiler(device=args.device)
    table = compiler.table(cache=cache)
    print(f"characterized {len(table)} macro configurations\n")

    print("== Table 2 via the joint composition engine (repro_torch.hetero) ==")
    reports, ok = {}, 0
    for t in gainsight.TASKS:
        rep = compiler.compose(t, space=table, cache=cache)
        reports[t.task_id] = rep
        got = rep.labels()
        exp = gainsight.TABLE2_EXPECTED[t.task_id]
        ok += got == exp
        tick = "OK " if got == exp else "!! "
        print(f"  {tick}task {t.task_id} {t.name:24s} "
              f"L1: {got['L1']:14s} L2: {got['L2']}")

    print("\n== composition report, task 7 (3-technology L2) ==")
    print(reports[7].summary())

    print("\n== simulate-then-rerank: replay phase traces vs the averages ==")
    rep_sim = compiler.simulate(gainsight.TASKS[6], space=table, cache=cache)
    m = rep_sim.best.metrics
    print(f"  winner unchanged at defaults: {rep_sim.labels()}")
    print(f"  replayed (prefill+decode):  E={m['sim_e_total_j'] * 1e6:.3f} uJ"
          f"  t={m['sim_t_sim_s'] * 1e3:.3f} ms"
          f"  stall={m['sim_stall_frac']:.1%}"
          f"  util_peak={m['sim_util_peak']:.3f}")
    runner = rep_sim.ranked[1].metrics
    print(f"  runner-up after re-rank:    E={runner['sim_e_total_j'] * 1e6:.3f} uJ"
          f"  (analytic p_w {runner['p_w'] * 1e3:.3f} mW)")

    print("\n== joint tradeoff: same task under a power-first objective ==")
    rep_p = compiler.compose(
        gainsight.TASKS[6], space=table,
        compose_policy=ComposePolicy(objective="power",
                                     candidate_mode="all_feasible"))
    m0, m1 = reports[7].best.metrics, rep_p.best.metrics
    print(f"  preference: {m0['p_w'] * 1e3:8.3f} mW  "
          f"{m0['area_um2'] / 1e6:7.3f} mm^2   {reports[7].labels()}")
    print(f"  power-min:  {m1['p_w'] * 1e3:8.3f} mW  "
          f"{m1['area_um2'] / 1e6:7.3f} mm^2   {rep_p.labels()}")

    print("\n== Pareto front (area, leak+refresh power, delay) ==")
    front = (table
             .with_column("p_static_w",
                          table["p_leak_w"] + table["p_refresh_w"])
             .pareto("area_um2", "p_static_w", "t_read_s"))
    print(f"  {len(front)}/{len(table)} non-dominated configs; examples:")
    for i in range(min(5, len(front))):
        c = front.config(i)
        print(f"    {c.mem_type:12s} {c.word_size}x{c.num_words} "
              f"LS={int(c.level_shift)} "
              f"area={front['area_um2'][i]:.0f}um2 "
              f"f={front['f_op_hz'][i] / 1e6:.0f}MHz")

    print("\n== beyond-paper: gradient-based continuous sizing ==")
    out = compiler.gradient_size(MacroConfig(mem_type="gc_sisi",
                                             word_size=64, num_words=128))
    print(f"  w_read {0.15:.2f}->{out['w_read_um']:.2f}um, "
          f"w_write {0.12:.2f}->{out['w_write_um']:.2f}um: "
          f"cell critical path {out['t_cell_before_s']*1e12:.1f}ps -> "
          f"{out['t_cell_after_s']*1e12:.1f}ps ({out['speedup']:.2f}x)")
    return {"ok": ok, "labels": {k: r.labels() for k, r in reports.items()},
            "sizing": out}


if __name__ == "__main__":
    main()
