"""HS: host syncs on the port's hot paths.

The counterpart of the JAX package's JP02 / JP03 half of ``jit_purity``.
The port has no ``jit``: what costs on the card is the host waiting for the
device. Scope: the functions reachable, through same-package call edges
(module functions, imported functions, ``self.`` / ``cls.`` methods,
``Class.method``; nested defs with their parent), from the hot entry points
in ``HOT_ENTRIES``: the characterization, ``explore`` / ``DesignTable.build``,
``compose``, ``score_grid``, ``simulate`` / ``simulate_traces``, the sizing,
``LM.prefill`` / ``LM.decode``, ``Engine.generate`` and the train step.

HS01  ``.item()`` / ``.tolist()`` (not on a numpy value) / ``.cpu()`` /
      ``.numpy()``, ``synchronize()``, or a blocking host-to-device copy:
      ``torch.tensor`` / ``torch.as_tensor`` with a ``device=``, ``.cuda()``,
      ``.to(<device>)``.
HS02  ``float()`` / ``int()`` / ``bool()`` of a tensor expression, or an
      ``if`` / ``while`` / ternary / ``assert`` testing one.
HS03  an op whose output's size depends on the data: ``nonzero``,
      ``argwhere``, ``masked_select``, ``unique``, one-argument
      ``torch.where``, a boolean-mask index, ``repeat_interleave`` of tensor
      repeats without ``output_size``.

HS01 also flags a host value stored into a tensor element (``t[i] = 3``).
A call on a receiver of no static type (``cell.to(dev)``) reaches every
method of that name in the port classes the module defines or imports.

A *tensor expression* is a ``torch.*`` / ``F.*`` call, a local assigned
from one, or arithmetic, indexing or a method call on one; ``.shape``,
``.dtype``, ``.device`` and the like are host values. Parameters are not
assumed to be tensors, so shape arithmetic on them does not flag. Branches
that only a CPU or meta tensor takes (``x.device.type == "cpu"``,
``meta.active(x)``) are not linted: no sync happens there. Type guards
(``isinstance``, ``is None``) do not flag. The card's witness
(``torch.cuda.set_sync_debug_mode``, ``chip_smoke.py`` phase 42) holds this
tier to every sync the card sees.
"""
from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from repro_torch.analysis.astutil import (
    Module, Project, classes_of, dotted, find_function, functions_of,
    import_aliases, methods_of,
)
from repro_torch.analysis.findings import Finding

PKG = "src/repro_torch"
# (module, qualname) of every hot entry point
HOT_ENTRIES: Tuple[Tuple[str, str], ...] = (
    ("src/repro_torch/core/characterize.py", "characterize_batch"),
    ("src/repro_torch/core/characterize.py", "characterize_corners"),
    ("src/repro_torch/api.py", "DesignTable.build"),
    ("src/repro_torch/api.py", "explore"),
    ("src/repro_torch/hetero/compose.py", "compose"),
    ("src/repro_torch/hetero/system.py", "score_grid"),
    ("src/repro_torch/hetero/system.py", "score_grid_corners"),
    ("src/repro_torch/api.py", "simulate"),
    ("src/repro_torch/sim/engine.py", "simulate_traces"),
    ("src/repro_torch/api.py", "gradient_size_macro"),
    ("src/repro_torch/models/lm.py", "LM.prefill"),
    ("src/repro_torch/models/lm.py", "LM.decode"),
    ("src/repro_torch/serve/engine.py", "Engine.generate"),
    ("src/repro_torch/train/step.py", "make_train_step"),
)
# the analyzer is not a hot path
SKIP_PREFIXES = (f"{PKG}/analysis/",)

_TENSOR_ROOTS = ("torch", "F")
# torch.* calls that return host values
_TORCH_HOST = {"is_tensor", "device", "dtype", "Size", "finfo", "iinfo",
               "is_grad_enabled", "no_grad", "enable_grad", "inference_mode",
               "get_default_dtype", "is_available", "device_count",
               "current_device", "get_device_name", "is_floating_point",
               "is_complex", "manual_seed", "Generator", "set_grad_enabled",
               "promote_types", "result_type", "can_cast", "Stream", "Event",
               "current_stream", "stream", "synchronize", "numel"}
# attributes of a tensor that are tensors; every other attribute (shape,
# dtype, device, ndim, ...) is a host value
_TENSOR_ATTRS = {"T", "mT", "H", "mH", "real", "imag", "grad", "data"}
# tensor methods that return host values
_HOST_METHODS = {"size", "dim", "numel", "element_size", "data_ptr",
                 "stride", "is_contiguous", "storage_offset", "nelement",
                 "get_device", "is_floating_point", "is_complex", "tolist",
                 "item", "type", "__len__", "untyped_storage", "nbytes",
                 "itemsize", "is_pinned", "is_set_to", "equal"}
_SYNC_METHODS = {"item", "tolist", "cpu", "numpy"}
_ALWAYS_SYNC_METHODS = {"cpu", "numpy", "synchronize"}
_SYNC_CASTS = {"float", "int", "bool"}
_DATA_SHAPE_OPS = {"nonzero", "argwhere", "masked_select", "unique",
                   "unique_consecutive"}
_MASK_FNS = {"isnan", "isfinite", "isinf", "isneginf", "isposinf",
             "logical_and", "logical_or", "logical_not", "logical_xor",
             "eq", "ne", "gt", "lt", "ge", "le", "greater", "less",
             "greater_equal", "less_equal", "isin", "bool"}
_TYPE_GUARDS = ("isinstance", "hasattr", "callable", "issubclass",
                "is_tensor")
_HOST_DEVICES = ("cpu", "meta")

FnKey = Tuple[str, str]           # (module rel path, qualname)


def _is_type_guard(test: ast.AST) -> bool:
    """Tests on types and identities (isinstance/hasattr/callable, ``is
    None``), and boolean combinations of them: host values, no sync."""
    if isinstance(test, ast.BoolOp):
        return all(_is_type_guard(v) for v in test.values)
    if isinstance(test, ast.UnaryOp) and isinstance(test.op, ast.Not):
        return _is_type_guard(test.operand)
    for node in ast.walk(test):
        if isinstance(node, ast.Call):
            callee = dotted(node.func)
            if callee and callee.split(".")[-1] in _TYPE_GUARDS:
                return True
        if isinstance(node, ast.Compare) and any(
                isinstance(op, (ast.Is, ast.IsNot)) for op in node.ops):
            return True
    return False


def _host_branch(test: ast.AST) -> Optional[str]:
    """Which branch of an ``if`` only a host tensor takes: "body" for
    ``x.device.type == "cpu"`` (or ``in ("cpu", ...)``, ``meta.active(x)``),
    "orelse" for ``!= "cpu"``; None when the test is no such device test."""
    if isinstance(test, ast.Call):
        callee = dotted(test.func) or ""
        return "body" if callee.endswith("meta.active") else None
    if not (isinstance(test, ast.Compare) and len(test.ops) == 1):
        return None
    left = dotted(test.left) or ""
    if not left.endswith("device.type"):
        return None
    right = test.comparators[0]
    vals = {n.value for n in ast.walk(right) if isinstance(n, ast.Constant)}
    if not vals or not vals <= set(_HOST_DEVICES):
        return None
    op = test.ops[0]
    if isinstance(op, (ast.Eq, ast.In)):
        return "body"
    if isinstance(op, (ast.NotEq, ast.NotIn)):
        return "orelse"
    return None


def _module_rel(project: Project, dotted_name: str) -> Optional[str]:
    """``repro_torch.a.b`` -> the repo-relative file of that module."""
    parts = dotted_name.split(".")
    if parts[0] != "repro_torch":
        return None
    base = "/".join(["src"] + parts)
    for rel in (f"{base}.py", f"{base}/__init__.py"):
        if project.module(rel) is not None:
            return rel
    return None


def _member(project: Project, rel: str, name: str,
            attr: Optional[str] = None) -> Optional[FnKey]:
    """``name`` (a function, or a class whose ``attr`` or ``__init__`` is
    called) defined in module ``rel``."""
    mod = project.module(rel)
    if mod is None:
        return None
    if attr is None and name in functions_of(mod.tree):
        return (rel, name)
    cls = classes_of(mod.tree).get(name)
    if cls is not None:
        meth = attr or "__init__"
        if meth in methods_of(cls):
            return (rel, f"{name}.{meth}")
    return None


def resolve_call(project: Project, mod: Module, aliases: Dict[str, str],
                 func: ast.AST, cls_name: Optional[str]) -> Optional[FnKey]:
    """The port function a call's ``func`` names, or None."""
    if isinstance(func, ast.Name):
        local = _member(project, mod.rel, func.id)
        if local:
            return local
        target = aliases.get(func.id)
        if target and target.startswith("repro_torch."):
            owner, _, name = target.rpartition(".")
            rel = _module_rel(project, owner)
            return _member(project, rel, name) if rel else None
        return None
    chain = dotted(func)
    if not chain:
        return None
    parts = chain.split(".")
    if parts[0] in ("self", "cls") and len(parts) == 2 and cls_name:
        return _member(project, mod.rel, cls_name, parts[1])
    if len(parts) == 2:
        head, attr = parts
        if head in classes_of(mod.tree):
            return _member(project, mod.rel, head, attr)
        target = aliases.get(head)
        if target and target.startswith("repro_torch."):
            rel = _module_rel(project, target)
            if rel:                        # alias of a module: module.fn
                return _member(project, rel, attr)
            owner, _, name = target.rpartition(".")
            rel = _module_rel(project, owner)
            return _member(project, rel, name, attr) if rel else None
        return None
    if len(parts) == 3:                    # package.module.fn
        target = aliases.get(parts[0])
        if target and target.startswith("repro_torch."):
            rel = _module_rel(project, f"{target}.{parts[1]}")
            return _member(project, rel, parts[2]) if rel else None
    return None


def method_candidates(project: Project, mod: Module,
                      aliases: Dict[str, str], name: str) -> Set[FnKey]:
    """Methods ``name`` of the port classes that ``mod`` defines or imports
    the module of: where a call's receiver has no static type (``x.to(dev)``
    on a ``DeviceParams``), the call may reach any of them."""
    rels = {mod.rel}
    for target in aliases.values():
        if target.startswith("repro_torch."):
            for dotted_name in (target, target.rpartition(".")[0]):
                rel = _module_rel(project, dotted_name)
                if rel:
                    rels.add(rel)
    out: Set[FnKey] = set()
    for rel in rels:
        other = project.module(rel)
        for cname, cls in classes_of(other.tree).items():
            if name in methods_of(cls):
                out.add((rel, f"{cname}.{name}"))
    return out


class _FnLinter(ast.NodeVisitor):
    """One function (nested defs included): tensor-local inference, flags,
    and outgoing call edges, skipping host-only branches."""

    def __init__(self, mod: Module, fn: ast.AST, aliases: Dict[str, str],
                 project: Project, cls_name: Optional[str]):
        self.mod = mod
        self.fn = fn
        self.aliases = aliases
        self.project = project
        self.cls_name = cls_name
        self.tensors: Set[str] = set()
        self.masks: Set[str] = set()
        self.host: Set[str] = set()      # locals holding numpy values
        self.findings: List[Finding] = []
        self.edges: Set[FnKey] = set()

    # -- value kinds -------------------------------------------------------
    def is_tensor(self, e: ast.AST) -> bool:
        if isinstance(e, ast.Name):
            return e.id in self.tensors
        if isinstance(e, ast.Call):
            callee = dotted(e.func) or ""
            root, last = callee.split(".")[0], callee.split(".")[-1]
            if root in _TENSOR_ROOTS and callee != root:
                return last not in _TORCH_HOST
            if isinstance(e.func, ast.Attribute):
                return (e.func.attr not in _HOST_METHODS
                        and self.is_tensor(e.func.value))
            return False
        if isinstance(e, ast.Attribute):
            return e.attr in _TENSOR_ATTRS and self.is_tensor(e.value)
        if isinstance(e, ast.Subscript):
            return self.is_tensor(e.value)
        if isinstance(e, ast.BinOp):
            return self.is_tensor(e.left) or self.is_tensor(e.right)
        if isinstance(e, ast.UnaryOp):
            return self.is_tensor(e.operand)
        if isinstance(e, ast.Compare):
            return any(self.is_tensor(x) for x in [e.left] + e.comparators)
        if isinstance(e, ast.BoolOp):
            return any(self.is_tensor(v) for v in e.values)
        if isinstance(e, ast.IfExp):
            return self.is_tensor(e.body) or self.is_tensor(e.orelse)
        return False

    def is_mask(self, e: ast.AST) -> bool:
        if isinstance(e, ast.Name):
            return e.id in self.masks
        if isinstance(e, ast.Compare):
            return any(self.is_tensor(x) for x in [e.left] + e.comparators)
        if isinstance(e, ast.UnaryOp) and isinstance(e.op, ast.Invert):
            return self.is_mask(e.operand)
        if isinstance(e, ast.BinOp) and isinstance(
                e.op, (ast.BitAnd, ast.BitOr, ast.BitXor)):
            return self.is_mask(e.left) or self.is_mask(e.right)
        if isinstance(e, ast.Call):
            callee = dotted(e.func) or ""
            last = callee.split(".")[-1]
            if last in _MASK_FNS:
                return (callee.split(".")[0] in _TENSOR_ROOTS
                        or (isinstance(e.func, ast.Attribute)
                            and self.is_tensor(e.func.value)))
        return False

    def is_host(self, e: ast.AST) -> bool:
        if isinstance(e, ast.Name):
            return e.id in self.host
        if isinstance(e, ast.Call):
            callee = dotted(e.func) or ""
            if callee.split(".")[0] in ("np", "numpy"):
                return True
            if isinstance(e.func, ast.Attribute):
                return self.is_host(e.func.value)
        if isinstance(e, (ast.Attribute, ast.Subscript)):
            return self.is_host(e.value)
        return False

    def _flag(self, rule: str, node: ast.AST, msg: str) -> None:
        self.findings.append(Finding(
            rule, self.mod.rel, node.lineno,
            f"{msg} (in hot-reachable {self.fn.name!r})",
            snippet=self.mod.snippet(node.lineno)))

    # -- statements --------------------------------------------------------
    def _visit_test(self, node, what: str) -> None:
        if not _is_type_guard(node.test) and self.is_tensor(node.test):
            self._flag("HS02", node, f"Python `{what}` on a tensor value")

    def visit_If(self, node: ast.If) -> None:
        host = _host_branch(node.test)
        self._visit_test(node, "if")
        self.visit(node.test)
        if host != "body":
            for s in node.body:
                self.visit(s)
        if host != "orelse":
            for s in node.orelse:
                self.visit(s)

    def visit_While(self, node: ast.While) -> None:
        self._visit_test(node, "while")
        self.generic_visit(node)

    def visit_Assert(self, node: ast.Assert) -> None:
        self._visit_test(node, "assert")
        self.generic_visit(node)

    def visit_IfExp(self, node: ast.IfExp) -> None:
        self._visit_test(node, "ternary")
        self.generic_visit(node)

    def _bind(self, targets, value) -> None:
        tensor, mask, host = (self.is_tensor(value), self.is_mask(value),
                              self.is_host(value))
        for t in targets:
            for n in _bound_names(t):
                if isinstance(n, ast.Name):
                    for kind, on in ((self.tensors, tensor),
                                     (self.masks, mask), (self.host, host)):
                        (kind.add if on else kind.discard)(n.id)

    def visit_Assign(self, node: ast.Assign) -> None:
        self.generic_visit(node)
        for t in node.targets:
            self._host_store(t, node.value)
        self._bind(node.targets, node.value)

    def visit_AnnAssign(self, node: ast.AnnAssign) -> None:
        self.generic_visit(node)
        if node.value is not None:
            self._bind([node.target], node.value)

    def visit_AugAssign(self, node: ast.AugAssign) -> None:
        self.generic_visit(node)
        if self.is_tensor(node.value) and isinstance(node.target, ast.Name):
            self.tensors.add(node.target.id)

    def _host_store(self, target: ast.AST, value: ast.AST) -> None:
        """``t[i] = v`` (or ``c[k][i] = v``, an element of a container's
        tensor) with a host value ``v``: the value is copied to the device
        and the host waits."""
        if isinstance(target, ast.Subscript) and _host_scalar(value) \
                and not self.is_tensor(value) \
                and (self.is_tensor(target.value)
                     or isinstance(target.value, ast.Subscript)) \
                and not self.is_host(target.value):
            self._flag("HS01", target, "a host value stored into a tensor "
                                       "element is copied to the device")

    def visit_Subscript(self, node: ast.Subscript) -> None:
        self.generic_visit(node)
        if self.is_tensor(node.value) and self.is_mask(node.slice):
            self._flag("HS03", node, "boolean-mask index (its size needs "
                                     "a host sync)")

    def visit_Call(self, node: ast.Call) -> None:
        self.generic_visit(node)
        callee = dotted(node.func) or ""
        parts = callee.split(".")
        last = parts[-1] if callee else (
            node.func.attr if isinstance(node.func, ast.Attribute) else "")
        method = isinstance(node.func, ast.Attribute)
        on_torch = parts[0] in _TENSOR_ROOTS
        receiver = node.func.value if method else None
        # HS01: reads to the host, synchronize
        if method and last in _ALWAYS_SYNC_METHODS:
            self._flag("HS01", node, f".{last}() waits for the device")
        elif method and last in _SYNC_METHODS and not on_torch \
                and not self.is_host(receiver):
            self._flag("HS01", node, f".{last}() copies to the host")
        # HS01: blocking copies to the device
        if on_torch and last in ("tensor", "as_tensor") and any(
                kw.arg == "device" and not _host_device(kw.value)
                for kw in node.keywords):
            self._flag("HS01", node, f"{callee}(..., device=) copies from "
                                     f"the host and waits")
        if method and last == "cuda" and not on_torch:
            self._flag("HS01", node, ".cuda() copies from the host and "
                                     "waits")
        if method and last == "to" and not on_torch and _moves(node):
            self._flag("HS01", node, ".to(<device>) copies between host and "
                                     "device and waits")
        # HS02: casts of tensor values
        if callee in _SYNC_CASTS and node.args and \
                self.is_tensor(node.args[0]):
            self._flag("HS02", node,
                       f"{callee}() of a tensor value waits for the device")
        # HS03: data-dependent output sizes
        tensor_call = on_torch or (method and self.is_tensor(receiver))
        if tensor_call and last in _DATA_SHAPE_OPS:
            self._flag("HS03", node, f"{last}() sizes its output from the "
                                     f"data (a host sync)")
        if on_torch and last == "where" and len(node.args) == 1 \
                and not node.keywords:
            self._flag("HS03", node, "one-argument torch.where is nonzero()")
        if tensor_call and last == "repeat_interleave" and not any(
                kw.arg == "output_size" for kw in node.keywords):
            repeats = node.args[1] if on_torch and len(node.args) > 1 else (
                node.args[0] if method and node.args else None)
            if repeats is None or self.is_tensor(repeats):
                self._flag("HS03", node, "repeat_interleave of tensor "
                                         "repeats without output_size")
        # call edges for reachability
        key = resolve_call(self.project, self.mod, self.aliases, node.func,
                           self.cls_name)
        if key:
            self.edges.add(key)
        elif method and not last.startswith("__"):
            self.edges |= method_candidates(self.project, self.mod,
                                            self.aliases, last)


def _bound_names(target: ast.AST):
    """The names an assignment target binds (not those it indexes)."""
    if isinstance(target, ast.Name):
        yield target
    elif isinstance(target, (ast.Tuple, ast.List)):
        for elt in target.elts:
            yield from _bound_names(elt)
    elif isinstance(target, ast.Starred):
        yield from _bound_names(target.value)


def _host_scalar(e: ast.AST) -> bool:
    """A value that is a Python number when it is no tensor: a constant, a
    name, arithmetic on them, ``int()`` / ``float()``."""
    if isinstance(e, (ast.Constant, ast.Name)):
        return True
    if isinstance(e, ast.BinOp):
        return _host_scalar(e.left) and _host_scalar(e.right)
    if isinstance(e, ast.UnaryOp):
        return _host_scalar(e.operand)
    if isinstance(e, ast.Call):
        return dotted(e.func) in ("int", "float", "bool")
    return False


def _host_device(e: ast.AST) -> bool:
    return isinstance(e, ast.Constant) and e.value in _HOST_DEVICES


def _device_like(e: ast.AST) -> bool:
    if isinstance(e, ast.BoolOp):
        return any(_device_like(v) for v in e.values)
    if isinstance(e, ast.IfExp):
        return _device_like(e.body) or _device_like(e.orelse)
    if isinstance(e, ast.Constant):
        return isinstance(e.value, str) and e.value not in _HOST_DEVICES
    if isinstance(e, ast.Call):
        return (dotted(e.func) or "").endswith("device")
    name = (dotted(e) or "").split(".")[-1]
    return name in ("dev", "device") or name.endswith("device")


def _moves(call: ast.Call) -> bool:
    """``x.to(...)`` naming a device (not a dtype alone)."""
    for kw in call.keywords:
        if kw.arg == "device":
            return not _host_device(kw.value)
    return any(_device_like(a) for a in call.args)


def _class_of(mod: Module, qualname: str) -> Optional[str]:
    return qualname.split(".")[0] if "." in qualname else None


def reachable(project: Project) -> Set[FnKey]:
    """Every function the hot entry points reach (the linted set)."""
    return _walk(project)[0]


def _walk(project: Project):
    visited: Set[FnKey] = set()
    findings: List[Finding] = []
    missing: List[FnKey] = []
    queue = sorted(HOT_ENTRIES)
    for key in HOT_ENTRIES:
        mod = project.module(key[0])
        if mod is None or find_function(mod, key[1]) is None:
            missing.append(key)
    while queue:
        key = queue.pop()
        if key in visited:
            continue
        visited.add(key)
        if not key[0].startswith(PKG + "/") or key[0].startswith(
                SKIP_PREFIXES):
            continue
        mod = project.module(key[0])
        fn = find_function(mod, key[1]) if mod is not None else None
        if fn is None:
            continue
        linter = _FnLinter(mod, fn, import_aliases(mod.tree), project,
                           _class_of(mod, key[1]))
        for stmt in fn.body:
            linter.visit(stmt)
        findings.extend(linter.findings)
        queue.extend(sorted(linter.edges - visited))
    return visited, findings, missing


def check(project: Project) -> List[Finding]:
    _, findings, missing = _walk(project)
    for rel, qual in missing:
        findings.append(Finding(
            "HS01", rel, 0, f"hot entry point {qual} no longer resolves: "
            f"the host-sync scope lost it (update HOT_ENTRIES)",
            snippet=f"HOT_ENTRIES<-{qual}"))
    # a function reached twice is linted once; identical findings collapse
    return list(dict.fromkeys(findings))
