"""Orchestrates the port's checkers, applies noqa + baseline, computes exit
codes."""
from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Dict, List, Optional, Sequence

from repro_torch.analysis import cache_keys, docs as docs_mod
from repro_torch.analysis import host_sync, kernel_cov, units
from repro_torch.analysis.astutil import Project
from repro_torch.analysis.findings import Baseline, Finding, is_suppressed
from repro_torch.analysis.rules import EXIT_BITS, RULES, family_of

DEFAULT_BASELINE = "analysis_baseline_torch.json"

CHECKERS = {
    "CK": cache_keys.check,
    "HS": host_sync.check,
    "US": units.check,
    "KC": kernel_cov.check,
}

# The semantic tier (imports torch, drives the entry points, launches the
# kernels on a card) is opt-in via --semantic / explicit --rules and loaded
# lazily, so plain AST runs never pay the torch import.
SEMANTIC_FAMILIES = ("LG", "DT", "RC")


@dataclasses.dataclass
class Report:
    findings: List[Finding]            # active: fail the build
    suppressed: List[Finding]          # silenced by inline  # noqa
    baselined: List[Finding]           # matched a committed baseline entry
    stale_baseline: List[dict]         # baseline entries matching nothing
    families_run: tuple = ()           # which rule families actually ran

    @property
    def exit_code(self) -> int:
        code = 0
        for f in self.findings:
            code |= EXIT_BITS.get(family_of(f.rule), 0)
        return code

    def to_dict(self) -> dict:
        by_family: Dict[str, int] = {}
        for f in self.findings:
            by_family[family_of(f.rule)] = \
                by_family.get(family_of(f.rule), 0) + 1
        return {
            "exit_code": self.exit_code,
            "families_run": list(self.families_run),
            "counts": {"active": len(self.findings),
                       "suppressed": len(self.suppressed),
                       "baselined": len(self.baselined),
                       "stale_baseline": len(self.stale_baseline),
                       "by_family": by_family},
            "findings": [f.to_dict() for f in self.findings],
            "suppressed": [f.to_dict() for f in self.suppressed],
            "baselined": [f.to_dict() for f in self.baselined],
            "stale_baseline": list(self.stale_baseline),
        }

    def format_text(self) -> str:
        lines = []
        for f in sorted(self.findings, key=lambda f: (f.path, f.line, f.rule)):
            title = RULES.get(f.rule, ("?",))[0]
            lines.append(f"{f.format()} [{title}]")
        n = len(self.findings)
        lines.append(f"repro_torch.analysis: {n} active finding(s), "
                     f"{len(self.baselined)} baselined, "
                     f"{len(self.suppressed)} noqa-suppressed")
        if self.stale_baseline:
            lines.append(f"note: {len(self.stale_baseline)} stale baseline "
                         f"entr(y/ies) no longer match anything — prune "
                         f"{DEFAULT_BASELINE}")
        return "\n".join(lines)


def run_analysis(root, checks: Optional[Sequence[str]] = None,
                 baseline_path=None, with_docs: bool = False,
                 with_semantic: bool = False,
                 project: Optional[Project] = None) -> Report:
    """Run the analyzer over the repo at ``root``.

    ``checks`` restricts to rule families (("CK", "US"), ...); ``with_docs``
    adds the DC family; ``with_semantic`` adds the LG/DT/RC tier (imports
    torch); ``project`` injects a pre-built (possibly overlaid) Project, the
    hook the analyzer's own tests use to mutate sources.
    """
    root = Path(root)
    if project is None:
        project = Project(root)
    selected = tuple(checks) if checks else tuple(CHECKERS)
    if with_semantic:
        selected += tuple(f for f in SEMANTIC_FAMILIES if f not in selected)
    families_run: List[str] = []
    raw: List[Finding] = []
    for fam in selected:
        if fam in CHECKERS:
            raw.extend(CHECKERS[fam](project))
            families_run.append(fam)
    semantic_selected = tuple(f for f in selected if f in SEMANTIC_FAMILIES)
    if semantic_selected:
        from repro_torch.analysis import semantic   # lazy: imports torch
        for fam in semantic_selected:
            raw.extend(semantic.CHECKERS[fam](project))
            families_run.append(fam)
    if with_docs or (checks and "DC" in checks):
        for d in docs_mod.check_links(root):
            raw.append(Finding(**d))
        for d in docs_mod.check_rule_docs(root, sorted(RULES)):
            raw.append(Finding(**d))
        for d in docs_mod.check_obs_docs(root):
            raw.append(Finding(**d))
        families_run.append("DC")

    return report_of(project, raw, families_run, baseline_path)


def report_of(project: Project, raw: Sequence[Finding],
              families_run: Sequence[str], baseline_path=None) -> Report:
    """Apply inline ``# noqa`` and the committed baseline to raw findings
    (also for findings a caller gathered itself, as the card's phase
    does)."""
    kept: List[Finding] = []
    suppressed: List[Finding] = []
    for f in raw:
        mod = project.module(f.path) if f.path.endswith(".py") else None
        line = mod.line(f.line) if (mod and f.line) else ""
        (suppressed if is_suppressed(f, line) else kept).append(f)
    if baseline_path is None:
        baseline_path = project.root / DEFAULT_BASELINE
    baseline = Baseline.load(baseline_path)
    active, baselined = baseline.split(kept)
    return Report(findings=active, suppressed=suppressed,
                  baselined=baselined,
                  stale_baseline=baseline.stale_entries(kept),
                  families_run=tuple(families_run))
