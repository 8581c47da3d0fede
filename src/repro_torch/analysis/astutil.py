"""Shared AST plumbing for the checkers.

``Project`` is the single entry point: it loads modules lazily from a root
directory and supports an *overlay* — a mapping of repo-relative path to
replacement source text — so tests can inject synthetic mutations
(e.g. "add a field to OperatingPoint", "delete the corners line from
grid_hash") without copying the tree to a tmpdir. Stdlib-only: the AST tier
parses the port's sources and imports none of them.
"""
from __future__ import annotations

import ast
import dataclasses
from pathlib import Path
from typing import Dict, Iterator, List, Optional


@dataclasses.dataclass
class Module:
    rel: str                 # repo-relative posix path
    path: Path               # absolute path (may not exist under overlay)
    source: str
    tree: ast.Module
    lines: List[str]         # source split into lines (0-based index)

    def line(self, lineno: int) -> str:
        """1-based source line, '' if out of range."""
        if 1 <= lineno <= len(self.lines):
            return self.lines[lineno - 1]
        return ""

    def snippet(self, lineno: int) -> str:
        return self.line(lineno).strip()


class Project:
    def __init__(self, root, overlay: Optional[Dict[str, str]] = None):
        self.root = Path(root)
        self.overlay = dict(overlay or {})
        self._cache: Dict[str, Optional[Module]] = {}

    def module(self, rel: str) -> Optional[Module]:
        rel = rel.replace("\\", "/")
        if rel in self._cache:
            return self._cache[rel]
        path = self.root / rel
        if rel in self.overlay:
            source = self.overlay[rel]
        elif path.is_file():
            source = path.read_text(encoding="utf-8")
        else:
            self._cache[rel] = None
            return None
        try:
            tree = ast.parse(source, filename=rel)
        except SyntaxError:
            self._cache[rel] = None
            return None
        mod = Module(rel=rel, path=path, source=source, tree=tree,
                     lines=source.splitlines())
        self._cache[rel] = mod
        return mod

    def iter_modules(self, rel_dir: str) -> Iterator[Module]:
        """All .py modules under a repo-relative directory (recursive)."""
        rel_dir = rel_dir.rstrip("/")
        seen = set()
        base = self.root / rel_dir
        if base.is_dir():
            for p in sorted(base.rglob("*.py")):
                rel = p.relative_to(self.root).as_posix()
                seen.add(rel)
                mod = self.module(rel)
                if mod is not None:
                    yield mod
        # overlay-only modules (paths that don't exist on disk)
        for rel in sorted(self.overlay):
            if rel.startswith(rel_dir + "/") and rel not in seen:
                mod = self.module(rel)
                if mod is not None:
                    yield mod


# ---------------------------------------------------------------------------
# node helpers
# ---------------------------------------------------------------------------

def dotted(node: ast.AST) -> Optional[str]:
    """'a.b.c' for a Name/Attribute chain, None for anything else."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def import_aliases(tree: ast.Module) -> Dict[str, str]:
    """Local name -> dotted module/object it refers to.

    Covers ``import a.b as c`` and ``from a.b import c [as d]``.
    """
    out: Dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                out[alias.asname or alias.name.split(".")[0]] = alias.name
        elif isinstance(node, ast.ImportFrom) and node.module:
            for alias in node.names:
                out[alias.asname or alias.name] = (
                    f"{node.module}.{alias.name}")
    return out


def functions_of(tree: ast.Module) -> Dict[str, ast.AST]:
    """Top-level function name -> def node (incl. async)."""
    out = {}
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out[node.name] = node
    return out


def classes_of(tree: ast.Module) -> Dict[str, ast.ClassDef]:
    return {node.name: node for node in tree.body
            if isinstance(node, ast.ClassDef)}


def methods_of(cls: ast.ClassDef) -> Dict[str, ast.AST]:
    return {node.name: node for node in cls.body
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef))}


def find_function(mod: Module, qualname: str) -> Optional[ast.AST]:
    """The def of a top-level function (``name``) or a method
    (``Class.name``) of ``mod``, None if there is none."""
    if "." in qualname:
        cls_name, meth = qualname.split(".", 1)
        cls = classes_of(mod.tree).get(cls_name)
        return None if cls is None else methods_of(cls).get(meth)
    return functions_of(mod.tree).get(qualname)


def is_dataclass(cls: ast.ClassDef) -> bool:
    for dec in cls.decorator_list:
        d = dotted(dec if not isinstance(dec, ast.Call) else dec.func)
        if d and d.split(".")[-1] == "dataclass":
            return True
    return False


def dataclass_fields(cls: ast.ClassDef) -> List[str]:
    """Annotated field names of a dataclass (or NamedTuple) body, in order."""
    fields = []
    for node in cls.body:
        if isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
            name = node.target.id
            if not name.startswith("_") and name != "ClassVar":
                # skip typing.ClassVar annotations
                ann = dotted(node.annotation)
                sub = (dotted(node.annotation.value)
                       if isinstance(node.annotation, ast.Subscript) else None)
                if (ann and ann.split(".")[-1] == "ClassVar") or (
                        sub and sub.split(".")[-1] == "ClassVar"):
                    continue
                fields.append(name)
    return fields


def names_read(node: ast.AST) -> set:
    """All Name ids loaded anywhere inside node."""
    return {n.id for n in ast.walk(node)
            if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Load)}


def arg_names(fn: ast.AST) -> List[str]:
    a = fn.args
    names = [x.arg for x in (a.posonlyargs + a.args + a.kwonlyargs)]
    if a.vararg:
        names.append(a.vararg.arg)
    if a.kwarg:
        names.append(a.kwarg.arg)
    return names


def string_value(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None
