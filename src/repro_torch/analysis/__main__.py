"""``python -m repro_torch.analysis``: the port's analyzer.

    python -m repro_torch.analysis                  # human output, exit bitmask
    python -m repro_torch.analysis --format=json    # machine-readable report
    python -m repro_torch.analysis --docs           # + link/anchor/rule-doc checks
    python -m repro_torch.analysis --semantic       # + LG/DT/RC (imports torch)
    python -m repro_torch.analysis --rules CK,US    # restrict to families
    python -m repro_torch.analysis --write-baseline # snapshot current findings
    python -m repro_torch.analysis --prune-baseline # drop stale baseline entries
    python -m repro_torch.analysis --list-rules     # rule catalog

Exit code is the OR of the family bits (CK=1 HS=2 US=4 KC=8 DC=16 LG=32
DT=64 RC=128) of every *active* finding: 0 means clean against the
committed baseline (``analysis_baseline_torch.json``). The default run
parses sources and imports neither torch nor jax; ``--semantic`` imports
torch and drives the entry points on the CPU, and on a card also launches
every kernel in guarded buffers.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from repro_torch.analysis.findings import Baseline
from repro_torch.analysis.rules import EXIT_BITS, FAMILIES, RULES, family_of
from repro_torch.analysis.runner import DEFAULT_BASELINE, run_analysis


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="static analysis of the PyTorch port (cache keys, host "
                    "syncs, unit suffixes, kernel coverage, docs)")
    ap.add_argument("--root", default=None,
                    help="repo root (default: auto-detect from this package)")
    ap.add_argument("--format", choices=("text", "json"), default="text")
    ap.add_argument("--out", default=None,
                    help="also write the JSON report to this file")
    ap.add_argument("--baseline", default=None,
                    help=f"baseline file (default: <root>/{DEFAULT_BASELINE})")
    ap.add_argument("--write-baseline", action="store_true",
                    help="write every current finding into the baseline "
                         "file (with TODO justifications) and exit 0")
    ap.add_argument("--docs", action="store_true",
                    help="also run the DC docs checks (links, anchors, "
                         "rule catalog)")
    ap.add_argument("--semantic", action="store_true",
                    help="also run the LG/DT/RC tier (imports torch, drives "
                         "the entry points; on a card launches every kernel "
                         "in guarded buffers)")
    ap.add_argument("--prune-baseline", action="store_true",
                    help="rewrite the baseline file dropping entries that "
                         "no longer match any finding of a family that ran "
                         "in this invocation, then exit 0")
    ap.add_argument("--rules", default=None,
                    help="comma-separated rule families to run "
                         f"(default: all of {','.join(FAMILIES)})")
    ap.add_argument("--list-rules", action="store_true")
    args = ap.parse_args(argv)

    if args.list_rules:
        for rid, (title, summary) in sorted(RULES.items()):
            bit = EXIT_BITS[family_of(rid)]
            print(f"{rid}  [{title}] (exit bit {bit})\n      {summary}")
        return 0

    root = Path(args.root) if args.root else _detect_root()
    checks = None
    if args.rules:
        checks = tuple(r.strip().upper() for r in args.rules.split(","))
        bad = [c for c in checks if c not in FAMILIES]
        if bad:
            ap.error(f"unknown rule famil(y/ies) {bad}; valid: {FAMILIES}")
    baseline = Path(args.baseline) if args.baseline else None

    report = run_analysis(root, checks=checks, baseline_path=baseline,
                          with_docs=args.docs, with_semantic=args.semantic)

    if args.write_baseline:
        path = baseline or (root / DEFAULT_BASELINE)
        Baseline.write(path, report.findings + report.baselined)
        print(f"wrote {len(report.findings) + len(report.baselined)} "
              f"entr(y/ies) to {path}")
        return 0

    if args.prune_baseline:
        path = baseline or (root / DEFAULT_BASELINE)
        kept, dropped = prune_baseline(path, report)
        print(f"pruned {dropped} stale entr(y/ies) from {path} "
              f"({kept} kept; families run: "
              f"{','.join(report.families_run) or 'none'})")
        return 0

    if args.out:
        with open(args.out, "w", encoding="utf-8") as fh:
            json.dump(report.to_dict(), fh, indent=2)
            fh.write("\n")
    if args.format == "json":
        print(json.dumps(report.to_dict(), indent=2))
    else:
        print(report.format_text())
    return report.exit_code


def prune_baseline(path, report) -> tuple:
    """Rewrite the baseline at ``path`` dropping stale entries.

    Only entries whose rule family actually *ran* in this invocation are
    prunable: a CK-only run must not delete LG entries it never
    re-checked. Returns (kept, dropped) counts.
    """
    baseline = Baseline.load(path)
    stale_keys = {(e["rule"], e["path"], e.get("snippet", ""))
                  for e in report.stale_baseline
                  if family_of(e["rule"]) in report.families_run}
    keep = [e for e in baseline.entries
            if (e["rule"], e["path"], e.get("snippet", "")) not in stale_keys]
    dropped = len(baseline.entries) - len(keep)
    with open(path, "w", encoding="utf-8") as fh:
        json.dump({"entries": keep}, fh, indent=2)
        fh.write("\n")
    return len(keep), dropped


def _detect_root() -> Path:
    """src/repro_torch/analysis/__main__.py -> the repo root three levels up
    from the package directory (editable installs and src layouts)."""
    pkg = Path(__file__).resolve().parent
    for cand in (pkg.parents[2], Path.cwd()):
        if (cand / "src" / "repro_torch").is_dir():
            return cand
    return Path.cwd()


if __name__ == "__main__":
    sys.exit(main())
