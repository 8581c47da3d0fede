"""Finding records, ``# noqa`` suppression, and the committed baseline.

A *finding* is one (rule, file, line, message) tuple. Two suppression layers
sit between a raw finding and a CI failure:

1. Inline ``# noqa`` comments on the flagged line — ``# noqa`` silences every
   rule on the line, ``# noqa: US01,HS02`` silences only the listed rules.
2. The committed baseline file (``analysis_baseline_torch.json``): a list of
   deliberate exceptions, each with a one-line justification. Baseline
   entries match on (rule, path, snippet) — *not* line numbers — so
   unrelated edits above a baselined site don't invalidate the entry, while
   editing the flagged line itself does (the snippet no longer matches and
   the finding resurfaces for re-review).
"""
from __future__ import annotations

import dataclasses
import json
import re
from typing import Dict, List, Optional, Sequence

_NOQA_RE = re.compile(r"#\s*noqa(?::\s*(?P<rules>[A-Z]{2}\d{2}(?:\s*,\s*[A-Z]{2}\d{2})*))?",
                      re.IGNORECASE)


@dataclasses.dataclass(frozen=True)
class Finding:
    rule: str            # e.g. "US01"
    path: str            # repo-relative, posix separators
    line: int            # 1-based; 0 for file/project-level findings
    message: str
    snippet: str = ""    # stripped source line, used for baseline matching

    def key(self):
        return (self.rule, self.path, self.snippet)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def format(self) -> str:
        loc = f"{self.path}:{self.line}" if self.line else self.path
        return f"{loc}: {self.rule} {self.message}"


def noqa_rules(source_line: str) -> Optional[frozenset]:
    """Rules suppressed by a ``# noqa`` comment on this line.

    Returns None if there is no noqa comment, an empty frozenset for a bare
    ``# noqa`` (suppress everything), or the set of named rule IDs.
    """
    m = _NOQA_RE.search(source_line)
    if m is None:
        return None
    rules = m.group("rules")
    if not rules:
        return frozenset()
    return frozenset(r.strip().upper() for r in rules.split(","))


def is_suppressed(finding: Finding, source_line: str) -> bool:
    rules = noqa_rules(source_line)
    if rules is None:
        return False
    return not rules or finding.rule in rules


# ---------------------------------------------------------------------------
# baseline file
# ---------------------------------------------------------------------------

class Baseline:
    """The committed list of deliberate, justified exceptions."""

    def __init__(self, entries: Sequence[dict] = ()):
        self.entries: List[dict] = [dict(e) for e in entries]
        self._keys = {(e["rule"], e["path"], e.get("snippet", ""))
                      for e in self.entries}

    @classmethod
    def load(cls, path) -> "Baseline":
        try:
            with open(path, "r", encoding="utf-8") as fh:
                data = json.load(fh)
        except FileNotFoundError:
            return cls()
        if isinstance(data, dict):
            data = data.get("entries", [])
        return cls(data)

    def matches(self, finding: Finding) -> bool:
        return finding.key() in self._keys

    def split(self, findings: Sequence[Finding]):
        """Partition findings into (active, baselined)."""
        active, baselined = [], []
        for f in findings:
            (baselined if self.matches(f) else active).append(f)
        return active, baselined

    def stale_entries(self, findings: Sequence[Finding]) -> List[dict]:
        """Baseline entries that matched no finding (candidates to delete)."""
        seen = {f.key() for f in findings}
        return [e for e in self.entries
                if (e["rule"], e["path"], e.get("snippet", "")) not in seen]

    @staticmethod
    def write(path, findings: Sequence[Finding],
              justifications: Optional[Dict[tuple, str]] = None) -> None:
        justifications = justifications or {}
        entries = [{
            "rule": f.rule,
            "path": f.path,
            "snippet": f.snippet,
            "justification": justifications.get(
                f.key(), "TODO: justify or fix"),
        } for f in sorted(findings, key=lambda f: (f.path, f.rule, f.snippet))]
        with open(path, "w", encoding="utf-8") as fh:
            json.dump({"entries": entries}, fh, indent=2, sort_keys=False)
            fh.write("\n")
