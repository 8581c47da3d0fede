"""CK: cache-key completeness over the port's three caches.

The port caches characterization tables (the ``DesignTable`` npz), composed
reports (``hetero/cache.py``) and simulated re-ranks (``sim_<key>.npz``)
under content fingerprints. The bug class is *key drift*: a new policy
field or physics input that does not flow into the key, so stale cached
results are served for new inputs. This checker pins the key-construction
sites and cross-checks them against what they must fingerprint:

CK01  every field of SelectionPolicy / ComposePolicy / TaskReq / SimPolicy /
      OperatingPoint (and MacroConfig vs VEC_FIELDS) must be *covered* by its
      key function: ``dataclasses.asdict``/``astuple``/``fields`` on the
      parameter, a direct ``param.field`` access, a same-module helper the
      parameter is passed to, or a method call on the parameter.
CK02  every parameter of a key function must be read in its body.
CK03  a key function must reference its required ingredients (``grid_hash``
      must reach ``corners_fingerprint`` and ``_hash_seed``).
CK04  ``_physics_fingerprint`` must take in every file of the import closure
      of ``core/characterize.py`` inside the port, the CUDA sources its
      kernel wrappers build included: hashed through ``_PHYSICS_SOURCES``,
      taken in by a named value (``kernels/build.py``'s ``NVCC_FLAGS``), or
      exempted in ``CLOSURE_EXEMPT`` with the reason it cannot change a
      characterized value.
CK05  a spec target (file / function / class) no longer exists, or an
      exemption names a file outside the closure: the spec rotted.
"""
from __future__ import annotations

import ast
import re
from typing import List, Optional, Set, Tuple

from repro_torch.analysis.astutil import (
    Module, Project, arg_names, classes_of, dataclass_fields, dotted,
    find_function, functions_of, names_read,
)
from repro_torch.analysis.findings import Finding

PKG = "src/repro_torch"

# (key-fn file, key-fn qualname, param name, dataclass file, dataclass name)
DATACLASS_SPECS: Tuple[Tuple[str, str, str, str, str], ...] = (
    ("src/repro_torch/hetero/cache.py", "report_key", "policy",
     "src/repro_torch/core/select.py", "SelectionPolicy"),
    ("src/repro_torch/hetero/cache.py", "report_key", "compose_policy",
     "src/repro_torch/hetero/compose.py", "ComposePolicy"),
    ("src/repro_torch/hetero/cache.py", "report_key", "task",
     "src/repro_torch/core/select.py", "TaskReq"),
    ("src/repro_torch/hetero/cache.py", "sim_report_key", "sim_policy",
     "src/repro_torch/sim/engine.py", "SimPolicy"),
    ("src/repro_torch/core/corners.py", "OperatingPoint.fingerprint", "self",
     "src/repro_torch/core/corners.py", "OperatingPoint"),
)

# (key-fn file, key-fn qualname, required ingredient names)
INGREDIENT_SPECS: Tuple[Tuple[str, str, Tuple[str, ...]], ...] = (
    ("src/repro_torch/api.py", "grid_hash",
     ("_hash_seed", "corners_fingerprint", "AXIS_NAMES")),
    ("src/repro_torch/api.py", "DesignTable.grid_hash",
     ("_hash_seed", "corners_fingerprint", "AXIS_NAMES")),
    ("src/repro_torch/core/corners.py", "corners_fingerprint",
     ("fingerprint",)),
    ("src/repro_torch/hetero/cache.py", "report_key", ("_task_fingerprint",)),
    ("src/repro_torch/hetero/cache.py", "sim_report_key", ("base_key",)),
)

# every key function: all parameters must be read (CK02)
KEY_FUNCTIONS: Tuple[Tuple[str, str], ...] = (
    ("src/repro_torch/hetero/cache.py", "report_key"),
    ("src/repro_torch/hetero/cache.py", "sim_report_key"),
    ("src/repro_torch/api.py", "grid_hash"),
    ("src/repro_torch/api.py", "DesignTable.grid_hash"),
    ("src/repro_torch/core/corners.py", "OperatingPoint.fingerprint"),
    ("src/repro_torch/core/corners.py", "corners_fingerprint"),
)

# the characterize grid must stack every config axis, or a new MacroConfig
# field never varies and never enters the grid hash
VEC_FIELDS_SPEC = ("src/repro_torch/core/macro.py", "VEC_FIELDS",
                   "MacroConfig")

# (file of the fingerprint, its function, the tuple of hashed paths it
# iterates, the start of the closure)
PHYSICS_FP_SPEC = ("src/repro_torch/api.py", "_physics_fingerprint",
                   "_PHYSICS_SOURCES", "core/characterize.py")

# closure files (relative to src/repro_torch) that the fingerprint takes in
# through a value rather than the file's bytes: the value's name must be
# referenced in the fingerprint function
COVERED_BY = {
    # the compiler flags decide the kernel's arithmetic (no fast math); the
    # rest of the file is the build's plumbing
    "kernels/build.py": "NVCC_FLAGS",
}

# closure files that cannot change a characterized value, and why
CLOSURE_EXEMPT = {
    "__init__.py": "package docstring only",
    "core/__init__.py": "package docstring only",
    "kernels/__init__.py": "package docstring only",
    "analysis/__init__.py": "package docstring only",
    "analysis/sanitize.py": "reads the outputs and raises; on or off the "
                            "results are bit-identical",
    "device.py": "resolves which device computes, not what is computed",
    "obs/__init__.py": "telemetry: spans and counters record, never alter "
                       "a value",
    "obs/export.py": "telemetry export: writes trace files only",
    "obs/metrics.py": "telemetry counters: record, never alter a value",
    "obs/trace.py": "telemetry spans: record, never alter a value",
}

_EXPAND_CALLS = {"asdict", "astuple", "fields"}
# calls of kernels/build.py that name a library of csrc/<name>.cu
_BUILD_CALLS = {"launch", "load", "build_library", "scratch_floats"}
_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.M)


def _coverage(mod: Module, fn: ast.AST, param: str,
              dc_mod: Module, dc_cls: Optional[ast.ClassDef],
              depth: int = 0) -> Set[str]:
    """Field names of ``param`` provably flowing into the key built by
    ``fn``. The sentinel '*' means full coverage (asdict and friends)."""
    covered: Set[str] = set()
    if depth > 4:
        return covered
    funcs = functions_of(mod.tree)
    dc_methods = ({n.name: n for n in dc_cls.body
                   if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}
                  if dc_cls is not None else {})
    for node in ast.walk(fn):
        if isinstance(node, ast.Attribute) and \
                isinstance(node.value, ast.Name) and node.value.id == param:
            covered.add(node.attr)
        if not isinstance(node, ast.Call):
            continue
        callee = dotted(node.func)
        first_arg_is_param = bool(
            node.args and isinstance(node.args[0], ast.Name)
            and node.args[0].id == param)
        if callee and callee.split(".")[-1] in _EXPAND_CALLS \
                and first_arg_is_param:
            covered.add("*")
            return covered
        if callee == "getattr" and first_arg_is_param and len(node.args) > 1:
            if isinstance(node.args[1], ast.Constant) and \
                    isinstance(node.args[1].value, str):
                covered.add(node.args[1].value)
        # helper(.., param, ..) defined in the same module: recurse with the
        # helper's matching parameter name
        if isinstance(node.func, ast.Name) and node.func.id in funcs:
            helper = funcs[node.func.id]
            hargs = arg_names(helper)
            for i, a in enumerate(node.args):
                if isinstance(a, ast.Name) and a.id == param and i < len(hargs):
                    covered |= _coverage(mod, helper, hargs[i], dc_mod,
                                         dc_cls, depth + 1)
        # param.method(...): recurse into the dataclass method as `self`
        if isinstance(node.func, ast.Attribute) and \
                isinstance(node.func.value, ast.Name) and \
                node.func.value.id == param and \
                node.func.attr in dc_methods:
            covered |= _coverage(dc_mod, dc_methods[node.func.attr], "self",
                                 dc_mod, dc_cls, depth + 1)
    return covered


def _references(fn: ast.AST, name: str) -> bool:
    for node in ast.walk(fn):
        if isinstance(node, ast.Name) and node.id == name:
            return True
        if isinstance(node, ast.Attribute) and node.attr == name:
            return True
    return False


def _spec_missing(findings: List[Finding], rel: str, what: str) -> None:
    findings.append(Finding("CK05", rel, 0, f"spec target missing: {what}",
                            snippet=what))


def _check_dataclass_specs(project: Project, findings: List[Finding]) -> None:
    for fn_rel, qual, param, dc_rel, dc_name in DATACLASS_SPECS:
        mod = project.module(fn_rel)
        dc_mod = project.module(dc_rel)
        if mod is None:
            _spec_missing(findings, fn_rel, f"file {fn_rel}")
            continue
        if dc_mod is None:
            _spec_missing(findings, dc_rel, f"file {dc_rel}")
            continue
        fn = find_function(mod, qual)
        if fn is None:
            _spec_missing(findings, fn_rel, f"function {qual}")
            continue
        dc_cls = classes_of(dc_mod.tree).get(dc_name)
        if dc_cls is None:
            _spec_missing(findings, dc_rel, f"class {dc_name}")
            continue
        covered = _coverage(mod, fn, param, dc_mod, dc_cls)
        if "*" in covered:
            continue
        for f in dataclass_fields(dc_cls):
            if f not in covered:
                findings.append(Finding(
                    "CK01", fn_rel, fn.lineno,
                    f"{dc_name}.{f} does not flow into {qual}: a value "
                    f"change would silently hit a stale cache entry",
                    snippet=f"{qual}<-{dc_name}.{f}"))


def _check_ingredients(project: Project, findings: List[Finding]) -> None:
    for fn_rel, qual, ingredients in INGREDIENT_SPECS:
        mod = project.module(fn_rel)
        if mod is None:
            _spec_missing(findings, fn_rel, f"file {fn_rel}")
            continue
        fn = find_function(mod, qual)
        if fn is None:
            _spec_missing(findings, fn_rel, f"function {qual}")
            continue
        for ing in ingredients:
            if not _references(fn, ing):
                findings.append(Finding(
                    "CK03", fn_rel, fn.lineno,
                    f"{qual} no longer references required key ingredient "
                    f"{ing!r}", snippet=f"{qual}<-{ing}"))


def _check_params_read(project: Project, findings: List[Finding]) -> None:
    for fn_rel, qual in KEY_FUNCTIONS:
        mod = project.module(fn_rel)
        fn = find_function(mod, qual) if mod is not None else None
        if fn is None:
            continue    # CK05 already raised by the other passes
        read = names_read(ast.Module(body=fn.body, type_ignores=[]))
        for p in arg_names(fn):
            if p.startswith("_"):
                continue
            if p not in read:
                findings.append(Finding(
                    "CK02", fn_rel, fn.lineno,
                    f"parameter {p!r} of key function {qual} is never read: "
                    f"it cannot affect the cache key",
                    snippet=f"{qual}({p})"))


def _check_vec_fields(project: Project, findings: List[Finding]) -> None:
    rel, var, dc_name = VEC_FIELDS_SPEC
    mod = project.module(rel)
    if mod is None:
        _spec_missing(findings, rel, f"file {rel}")
        return
    dc_cls = classes_of(mod.tree).get(dc_name)
    if dc_cls is None:
        _spec_missing(findings, rel, f"class {dc_name}")
        return
    vec_node = _module_assign(mod, var)
    if vec_node is None:
        _spec_missing(findings, rel, f"assignment {var}")
        return
    listed = {n.value for n in ast.walk(vec_node.value)
              if isinstance(n, ast.Constant) and isinstance(n.value, str)}
    for f in dataclass_fields(dc_cls):
        if f not in listed:
            findings.append(Finding(
                "CK01", rel, vec_node.lineno,
                f"{dc_name}.{f} missing from {var}: the axis would never "
                f"vary in the characterize grid and never enter the grid "
                f"hash", snippet=f"{var}<-{dc_name}.{f}"))


def _module_assign(mod: Module, name: str) -> Optional[ast.Assign]:
    for node in mod.tree.body:
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == name
                for t in node.targets):
            return node
    return None


def _module_file(project: Project, dotted_name: str) -> Optional[str]:
    """``repro_torch.a.b`` -> ``a/b.py`` or ``a/b/__init__.py`` (relative to
    the package), whichever exists; None outside the port."""
    parts = dotted_name.split(".")
    if parts[0] != "repro_torch":
        return None
    base = "/".join(parts[1:])
    for rel in ((f"{base}.py" if base else None),
                (f"{base}/__init__.py" if base else "__init__.py")):
        if rel and project.module(f"{PKG}/{rel}") is not None:
            return rel
    return None


def _imported_files(project: Project, mod: Module) -> Set[str]:
    out: Set[str] = set()
    for node in ast.walk(mod.tree):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module \
                and node.level == 0:
            names = [node.module] + [f"{node.module}.{a.name}"
                                     for a in node.names]
        for name in names:
            parts = name.split(".")
            # importing a.b.c runs the __init__ of every package on the way
            for i in range(1, len(parts) + 1):
                rel = _module_file(project, ".".join(parts[:i]))
                if rel:
                    out.add(rel)
    return out


def _cuda_sources(project: Project, mod: Module) -> Set[str]:
    """csrc files a module builds: ``build.launch("name", ...)`` and friends
    name ``csrc/<name>.cu``, whose quoted includes follow."""
    out: Set[str] = set()
    for node in ast.walk(mod.tree):
        if not isinstance(node, ast.Call) or not node.args:
            continue
        callee = dotted(node.func) or ""
        if callee.split(".")[-1] not in _BUILD_CALLS:
            continue
        arg = node.args[0]
        if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
            out.add(f"kernels/csrc/{arg.value}.cu")
    todo = list(out)
    while todo:
        path = project.root / PKG / todo.pop()
        if not path.is_file():
            continue
        for inc in _INCLUDE.findall(path.read_text(encoding="utf-8")):
            rel = f"kernels/csrc/{inc}"
            if rel not in out:
                out.add(rel)
                todo.append(rel)
    return out


def import_closure(project: Project, start: str) -> Set[str]:
    """Files (relative to ``src/repro_torch``) that importing ``start``
    executes inside the port, and the CUDA sources those modules build."""
    seen: Set[str] = set()
    todo = [start] + [rel for rel in _imported_files(
        project, _parse(f"import repro_torch.{start[:-3].replace('/', '.')}"))]
    while todo:
        rel = todo.pop()
        if rel in seen:
            continue
        seen.add(rel)
        if not rel.endswith(".py"):
            continue
        mod = project.module(f"{PKG}/{rel}")
        if mod is None:
            continue
        todo.extend(_imported_files(project, mod) - seen)
        todo.extend(_cuda_sources(project, mod) - seen)
    return seen


def _parse(source: str) -> Module:
    return Module(rel="<spec>", path=None, source=source,
                  tree=ast.parse(source), lines=[source])


def _check_physics_fingerprint(project: Project,
                               findings: List[Finding]) -> None:
    api_rel, fp_name, tuple_name, start = PHYSICS_FP_SPEC
    mod = project.module(api_rel)
    if mod is None:
        _spec_missing(findings, api_rel, f"file {api_rel}")
        return
    fn = functions_of(mod.tree).get(fp_name)
    if fn is None:
        _spec_missing(findings, api_rel, f"function {fp_name}")
        return
    sources = _module_assign(mod, tuple_name)
    if sources is None or not _references(fn, tuple_name):
        _spec_missing(findings, api_rel,
                      f"{tuple_name} hashed by {fp_name}")
        return
    hashed = {n.value for n in ast.walk(sources.value)
              if isinstance(n, ast.Constant) and isinstance(n.value, str)}
    hashed |= {rel for rel, name in COVERED_BY.items()
               if _references(fn, name)}
    if project.module(f"{PKG}/{start}") is None:
        _spec_missing(findings, api_rel, f"file {PKG}/{start}")
        return
    closure = import_closure(project, start)
    for rel in sorted(closure - hashed - set(CLOSURE_EXEMPT)):
        findings.append(Finding(
            "CK04", api_rel, fn.lineno,
            f"{rel} is in the import closure of {start} but is neither "
            f"hashed by {fp_name} nor exempted: edits there would not "
            f"invalidate cached tables", snippet=f"{fp_name}<-{rel}"))
    for rel in sorted(set(CLOSURE_EXEMPT) - closure):
        _spec_missing(findings, api_rel,
                      f"exemption {rel} outside the closure of {start}")


def check(project: Project) -> List[Finding]:
    findings: List[Finding] = []
    _check_dataclass_specs(project, findings)
    _check_ingredients(project, findings)
    _check_params_read(project, findings)
    _check_vec_fields(project, findings)
    _check_physics_fingerprint(project, findings)
    return findings
