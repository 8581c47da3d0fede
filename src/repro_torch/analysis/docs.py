"""DC: documentation checks of the port (links, anchors, rule catalog).

Stdlib-only and free of intra-package imports, as the JAX package's docs
checker is, so it runs without the package importable.

DC01  a markdown link of the port's docs targets a file that does not exist
DC02  a markdown link targets a ``#anchor`` with no matching heading slug
DC03  a rule ID of the port's analyzer is not documented in
      ``docs/ANALYSIS_TORCH.md``
DC04  a ``repro_torch.obs`` catalog entry (span/metric name) is not
      documented in ``docs/OBSERVABILITY_TORCH.md``

The port's docs are ``docs/*_TORCH.md`` and the README's port section (the
``## PyTorch/CUDA port`` heading up to the next ``## `` heading). Findings
are plain dicts (``rule``/``path``/``line``/``message``/``snippet``); the
runner adapts them.
"""
from __future__ import annotations

import re
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

_LINK = re.compile(r"!?\[[^\]]*\]\(([^)\s]+)(?:\s+\"[^\"]*\")?\)")
_FENCE = re.compile(r"^(```|~~~).*?^\1\s*$", re.M | re.S)
_HEADING = re.compile(r"^#{1,6}\s+(.*?)\s*#*\s*$", re.M)
_EXTERNAL = re.compile(r"^[a-zA-Z][a-zA-Z0-9+.-]*:")  # http:, mailto:, ...

PORT_DOCS = "docs/*_TORCH.md"
README_SECTION = "## PyTorch/CUDA port"
RULE_CATALOG_MD = "docs/ANALYSIS_TORCH.md"
OBS_CATALOG_MD = "docs/OBSERVABILITY_TORCH.md"
OBS_CATALOG_PY = "src/repro_torch/obs/catalog.py"


def _finding(rule: str, path: str, line: int, message: str,
             snippet: str = "") -> Dict[str, object]:
    return {"rule": rule, "path": path, "line": line, "message": message,
            "snippet": snippet}


def slugify(heading: str) -> str:
    """GitHub-style anchor slug for one heading line (underscores are
    preserved, as GitHub keeps them)."""
    text = re.sub(r"\[([^\]]*)\]\([^)]*\)", r"\1", heading)
    text = text.replace("`", "").replace("*", "").strip().lower()
    text = re.sub(r"[^\w\- ]", "", text, flags=re.UNICODE)
    return text.replace(" ", "-")


def anchors_of(path: Path) -> frozenset:
    """All heading anchors of a markdown file, with -N duplicate suffixes."""
    body = _FENCE.sub("", path.read_text(encoding="utf-8"))
    seen: dict = {}
    out = set()
    for m in _HEADING.finditer(body):
        slug = slugify(m.group(1))
        n = seen.get(slug, 0)
        seen[slug] = n + 1
        out.add(slug if n == 0 else f"{slug}-{n}")
    return frozenset(out)


def _line_of(body: str, pos: int) -> int:
    return body.count("\n", 0, pos) + 1


def readme_section(text: str) -> Optional[Tuple[int, int]]:
    """1-based (first, last) lines of the README's port section."""
    lines = text.splitlines()
    start = next((i for i, ln in enumerate(lines)
                  if ln.startswith(README_SECTION)), None)
    if start is None:
        return None
    end = next((i for i in range(start + 1, len(lines))
                if lines[i].startswith("## ")), len(lines))
    return start + 1, end


def port_docs(root) -> List[Tuple[Path, Optional[Tuple[int, int]]]]:
    """(file, line range or None for all of it) of every port doc."""
    root = Path(root)
    files: List[Tuple[Path, Optional[Tuple[int, int]]]] = [
        (p, None) for p in sorted(root.glob(PORT_DOCS))]
    readme = root / "README.md"
    if readme.exists():
        span = readme_section(readme.read_text(encoding="utf-8"))
        if span is not None:
            files.append((readme, span))
    return files


def check_links(root, files: Sequence = None) -> List[Dict[str, object]]:
    """DC01/DC02 over the port's docs (or an explicit list of files, each a
    path or a (path, (first, last)) pair)."""
    root = Path(root)
    if files is None:
        files = port_docs(root)
    findings: List[Dict[str, object]] = []
    anchor_cache: Dict[Path, frozenset] = {}
    for entry in files:
        path, span = entry if isinstance(entry, tuple) else (entry, None)
        path = Path(path)
        if not path.is_absolute():
            path = root / path
        if not path.exists():
            findings.append(_finding("DC01", _rel(root, path), 0,
                                     "no such file", snippet=str(path.name)))
            continue
        raw = path.read_text(encoding="utf-8")
        body = _FENCE.sub(lambda m: "\n" * m.group(0).count("\n"), raw)
        for m in _LINK.finditer(body):
            target = m.group(1)
            if _EXTERNAL.match(target):
                continue
            line = _line_of(body, m.start())
            if span is not None and not span[0] <= line <= span[1]:
                continue
            file_part, _, anchor = target.partition("#")
            dest = path if not file_part else (
                path.parent / file_part).resolve()
            if not dest.exists():
                findings.append(_finding(
                    "DC01", _rel(root, path), line,
                    f"broken link {target!r} (no such file {file_part})",
                    snippet=target))
                continue
            if anchor and dest.suffix.lower() in (".md", ".markdown"):
                if dest not in anchor_cache:
                    anchor_cache[dest] = anchors_of(dest)
                if anchor not in anchor_cache[dest]:
                    findings.append(_finding(
                        "DC02", _rel(root, path), line,
                        f"broken anchor {target!r} (no heading slug "
                        f"'#{anchor}' in {_rel(root, dest)})",
                        snippet=target))
    return findings


def check_rule_docs(root, rule_ids: Sequence[str]) -> List[Dict[str, object]]:
    """DC03: every rule ID of the port's analyzer must appear in
    docs/ANALYSIS_TORCH.md."""
    root = Path(root)
    catalog = root / RULE_CATALOG_MD
    if not catalog.exists():
        return [_finding("DC03", RULE_CATALOG_MD, 0,
                         f"rule catalog {RULE_CATALOG_MD} does not exist",
                         snippet=RULE_CATALOG_MD)]
    body = catalog.read_text(encoding="utf-8")
    return [_finding("DC03", RULE_CATALOG_MD, 0,
                     f"rule {rid} is not documented in {RULE_CATALOG_MD}",
                     snippet=rid)
            for rid in rule_ids if rid not in body]


def check_obs_docs(root) -> List[Dict[str, object]]:
    """DC04: every span/metric name in the ``repro_torch.obs`` catalog must
    appear backticked in docs/OBSERVABILITY_TORCH.md. The catalog module is
    stdlib-only pure data and is loaded standalone (importlib)."""
    import importlib.util

    root = Path(root)
    cat_py = root / OBS_CATALOG_PY
    if not cat_py.exists():
        return [_finding("DC04", OBS_CATALOG_PY, 0,
                         "obs catalog module does not exist",
                         snippet=OBS_CATALOG_PY)]
    spec = importlib.util.spec_from_file_location("_torch_obs_catalog",
                                                  cat_py)
    catalog = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(catalog)

    doc = root / OBS_CATALOG_MD
    if not doc.exists():
        return [_finding("DC04", OBS_CATALOG_MD, 0,
                         f"obs catalog {OBS_CATALOG_MD} does not exist",
                         snippet=OBS_CATALOG_MD)]
    body = doc.read_text(encoding="utf-8")
    return [_finding("DC04", OBS_CATALOG_MD, 0,
                     f"obs {kind} {name!r} is not documented in "
                     f"{OBS_CATALOG_MD}", snippet=name)
            for kind, names in (("span", catalog.SPANS),
                                ("metric", catalog.METRICS))
            for name in names if f"`{name}`" not in body]


def _rel(root: Path, path: Path) -> str:
    try:
        return path.resolve().relative_to(Path(root).resolve()).as_posix()
    except ValueError:
        return str(path)
