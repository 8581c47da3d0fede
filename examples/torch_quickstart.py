"""Quickstart of the PyTorch port: the three-pillar compiler API in ~20
lines, as ``examples/quickstart.py`` does it through the JAX package.

1. ``Compiler().compile(cfg) -> Macro`` — characterize one macro (PPA +
   retention, one launch of the retention kernel on the card) and emit its
   design-flow artifacts (.sp/.v/.lib/.lef).
2. ``DesignTable`` — the characterized config grid as a columnar table with
   chainable ``feasible``/``pareto``/``best`` queries and npz caching.
3. ``explore() -> DSEReport`` — the full heterogeneous-memory DSE
   (paper Table 2) in one call; see examples/torch_heterogeneous_dse.py.
4. Operating corners — GCRAM retention vs temperature/VDD
   (``OperatingPoint``/``corners=``/``robust="worst_case"``).

Runs on the CUDA device unless ``--device cpu`` is given (without a card
the default raises); artifacts and the table cache go under ``--out``::

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu] [--out artifacts]
"""
import argparse
from pathlib import Path

from repro_torch.api import Compiler, OperatingPoint


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    ap.add_argument("--out", default="artifacts",
                    help="directory of the emitted macro and the table cache")
    args = ap.parse_args(argv)
    out = Path(args.out)
    cache = out / "dse_cache"

    compiler = Compiler(device=args.device)
    m = compiler.compile(mem_type="gc_sisi", word_size=32, num_words=64,
                         level_shift=True)
    cfg = m.config
    print(f"== OpenGCRAM (PyTorch port) quickstart: {cfg.mem_type} "
          f"{cfg.word_size}x{cfg.num_words} (WWLLS={cfg.level_shift}) ==")
    r = m.ppa
    print(f"area       {r['area_um2']:.0f} um^2")
    print(f"f_read     {r['f_read_hz'] / 1e6:.0f} MHz   "
          f"f_write {r['f_write_hz'] / 1e6:.0f} MHz")
    print(f"bandwidth  {r['bandwidth_bits_s'] / 8e9:.2f} GB/s (read) / "
          f"{r['bandwidth_total_bits_s'] / 8e9:.2f} GB/s (dual-port total)")
    print(f"leakage    {r['p_leak_w'] * 1e6:.3f} uW   "
          f"retention {m.retention_s:.3e} s")
    rep = m.write_all(out / "quickstart")
    print(f"artifacts  -> {out / 'quickstart'}/  "
          f"DRC {'clean' if rep['drc_clean'] else 'ERRORS'}, "
          f"LVS {'clean' if rep['lvs_clean'] else 'ERRORS'}")

    # pillar 2 in one line: the cheapest macro that runs 1 GHz for >= 1 ms
    table = compiler.table(cache=cache)
    pick = table.feasible(1.0e9, 1e-3).best("area_um2")
    print(f"1GHz/1ms   cheapest feasible macro: {pick}")

    # pillar 4: retention vs temperature — the knob that flips DSE winners.
    # GCRAM retention is Arrhenius-steep in T: the same OS-Si macro that
    # holds data for ms at 300 K drops below a 5 ms lifetime at 85 degC, so
    # a corner-blind DSE can crown a hot-infeasible winner (fix: build the
    # table with corners=[...] and rank with robust="worst_case").
    print("\n== retention vs operating point (gc_ossi 32x64) ==")
    for vdd, temp_k, label in [(1.1, 233.0, "cold  -40C"),
                               (1.1, 300.0, "nominal   "),
                               (1.1, 358.0, "hot   85C "),
                               (0.9, 300.0, "low-vdd   ")]:
        mc = compiler.compile(mem_type="gc_ossi", word_size=32, num_words=64,
                              op=OperatingPoint(vdd, temp_k, label.strip()))
        print(f"  {label}  vdd={vdd:.1f}V T={temp_k:.0f}K   "
              f"retention {mc.retention_s:10.3e} s   "
              f"p_refresh {mc.ppa['p_refresh_w'] * 1e6:8.3f} uW")

    corner_table = compiler.table(corners=["nominal", "hot"], cache=cache)
    robust = corner_table.worst_case_metrics()
    n_nom = int((table.metrics["retention_s"] >= 5e-3).sum())
    n_rob = int((robust["retention_s"] >= 5e-3).sum())
    print(f"configs holding a 5 ms lifetime: {n_nom} at nominal, "
          f"{n_rob} at every corner (robust)")
    return {"macro": m, "drc_clean": rep["drc_clean"],
            "lvs_clean": rep["lvs_clean"], "n_nominal": n_nom,
            "n_robust": n_rob}


if __name__ == "__main__":
    main()
