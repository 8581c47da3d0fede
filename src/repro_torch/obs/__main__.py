"""CLI: ``python -m repro_torch.obs report trace.json`` → stage-time
table."""
from __future__ import annotations

import argparse
import sys

from repro_torch.obs import report as report_mod


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs",
        description="repro_torch.obs trace tooling "
                    "(see docs/OBSERVABILITY_TORCH.md)")
    sub = ap.add_subparsers(dest="cmd", required=True)
    p_report = sub.add_parser(
        "report", help="render a stage-time/counter table from a trace file")
    p_report.add_argument("trace", help="trace file (.json Chrome format "
                                        "or .jsonl event log)")
    args = ap.parse_args(argv)
    if args.cmd == "report":
        print(report_mod.render_file(args.trace))
    return 0


if __name__ == "__main__":
    sys.exit(main())
