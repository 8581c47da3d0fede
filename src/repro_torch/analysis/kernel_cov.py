"""KC: kernel coverage, the port's counterpart of the JAX package's BK.

The port has no backend registry: each wrapper dispatches on its tensor's
device (``ROADMAP.md``). The invariant BK guards is the port's own rule all
the same: every hand-written CUDA library has a wrapper that launches it, a
plain PyTorch version that the CPU tests hold to the JAX reference, a card
test and a ``chip_smoke.py`` phase. The libraries are the keys of
``kernels/build.py``'s ``LAUNCH_ARGTYPES``.

KC01  a library is launched by no wrapper: no ``build.launch("<name>", ...)``
      call in ``kernels/*.py``.
KC02  a library has no plain version in ``kernels/ref.py`` (``PLAIN_VERSIONS``
      names it), or no CPU test (``tests/test_torch_*.py`` but the card's
      file) references that plain version.
KC03  no ``cuda``-marked test, or no ``chip_smoke.py`` line, names the
      library's public wrapper.
"""
from __future__ import annotations

import ast
import re
from typing import Dict, List, Optional, Set, Tuple

from repro_torch.analysis.astutil import (
    Module, Project, dotted, functions_of,
)
from repro_torch.analysis.findings import Finding

BUILD_REL = "src/repro_torch/kernels/build.py"
KERNELS_DIR = "src/repro_torch/kernels"
REF_REL = "src/repro_torch/kernels/ref.py"
TESTS_DIR = "tests"
CARD_TESTS = "tests/test_torch_cuda.py"
SMOKE = "chip_smoke.py"

# library -> its plain version in kernels/ref.py
PLAIN_VERSIONS = {
    "retention": "retention_ref",
    "ssm_scan": "ssm_scan_ref",
    "ssm_scan_bwd": "ssm_scan_ref_grads",
    "flash_attention": "attention_ref",
    "flash_attention_bwd": "attention_ref_grads",
}


def libraries(project: Project) -> Tuple[List[str], int]:
    """The keys of ``LAUNCH_ARGTYPES`` and the line of its assignment."""
    mod = project.module(BUILD_REL)
    if mod is None:
        return [], 0
    for node in mod.tree.body:
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == "LAUNCH_ARGTYPES"
                for t in node.targets) and isinstance(node.value, ast.Dict):
            return [k.value for k in node.value.keys
                    if isinstance(k, ast.Constant)], node.lineno
    return [], 0


def _launch_sites(project: Project) -> Dict[str, List[Tuple[Module, str]]]:
    """library -> [(module, function)] whose body calls build.launch of it."""
    out: Dict[str, List[Tuple[Module, str]]] = {}
    for mod in project.iter_modules(KERNELS_DIR):
        if mod.rel == BUILD_REL:
            continue
        for name, fn in functions_of(mod.tree).items():
            for node in ast.walk(fn):
                if isinstance(node, ast.Call) and \
                        (dotted(node.func) or "").endswith("launch") and \
                        node.args and isinstance(node.args[0], ast.Constant):
                    out.setdefault(node.args[0].value, []).append((mod, name))
    return out


def public_wrappers(mod: Module, name: str) -> Set[str]:
    """The public functions of ``mod`` that are, or call, ``name``."""
    if not name.startswith("_"):
        return {name}
    return {fname for fname, fn in functions_of(mod.tree).items()
            if not fname.startswith("_") and any(
                isinstance(n, ast.Call) and isinstance(n.func, ast.Name)
                and n.func.id == name for n in ast.walk(fn))}


def _mentions(source: str, name: str) -> bool:
    return re.search(rf"\b{re.escape(name)}\b", source) is not None


def check(project: Project) -> List[Finding]:
    findings: List[Finding] = []
    libs, line = libraries(project)
    build = project.module(BUILD_REL)
    snippet = build.snippet(line) if build is not None and line else ""
    if not libs:
        findings.append(Finding("KC01", BUILD_REL, 0, "LAUNCH_ARGTYPES not "
                                "found: no library to hold to its wrapper",
                                snippet="LAUNCH_ARGTYPES"))
        return findings
    sites = _launch_sites(project)
    ref = project.module(REF_REL)
    cpu_tests = [m.source for m in project.iter_modules(TESTS_DIR)
                 if m.rel.startswith("tests/test_torch_")
                 and m.rel != CARD_TESTS]
    card = [m.source for m in project.iter_modules(TESTS_DIR)
            if "mark.cuda" in m.source]
    smoke = project.module(SMOKE)

    def emit(rule: str, lib: str, msg: str) -> None:
        findings.append(Finding(rule, BUILD_REL, line, f"library {lib!r}: "
                                f"{msg}", snippet=f"{snippet}<-{lib}"))

    for lib in libs:
        wrappers: Set[str] = set()
        for mod, fname in sites.get(lib, ()):
            wrappers |= public_wrappers(mod, fname)
        if not wrappers:
            emit("KC01", lib, "no wrapper in kernels/ calls "
                              f"build.launch({lib!r}, ...)")
        plain: Optional[str] = PLAIN_VERSIONS.get(lib)
        if plain is None or ref is None or \
                plain not in functions_of(ref.tree):
            emit("KC02", lib, f"no plain version in {REF_REL} "
                              f"(PLAIN_VERSIONS: {plain!r})")
        elif not any(_mentions(src, plain) for src in cpu_tests):
            emit("KC02", lib, f"no CPU test references its plain version "
                              f"{plain!r}")
        if wrappers and not any(_mentions(src, w) for src in card
                                for w in wrappers):
            emit("KC03", lib, f"no cuda-marked test calls {sorted(wrappers)}")
        if wrappers and (smoke is None or not any(
                _mentions(smoke.source, w) for w in wrappers)):
            emit("KC03", lib, f"no {SMOKE} phase calls {sorted(wrappers)}")
    return findings
