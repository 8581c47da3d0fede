"""US: unit-suffix lint over the physics layer.

The characterization pipeline's convention (stated in ``api.py``'s module
docstring, the same in the port as in the JAX package) is that every physical binding carries its unit in the name:
``_um2`` area, ``_w`` power, ``_s`` time, ``_hz`` frequency, ``_v`` voltage,
``_j`` energy, ``_a`` current, ``_f`` capacitance, ``_ohm`` resistance,
``_k`` temperature, ``_bits``/``_bits_s`` capacity/bandwidth. This checker
does lightweight dimensional algebra over SI base dimensions to enforce it:

US01  a physics binding with no unit suffix, triggered by (a) a quantity
      prefix (``t_`` time, ``e_`` energy, ``p_`` power, ``f_`` frequency,
      ``i_``/``l_`` current, ``c_`` capacitance, ``r_`` resistance, ``v_``
      voltage) or a quantity word (``area``/``delay``/``energy``/``leak``),
      or (b) a right-hand side whose unit is inferable and non-dimensionless.
US02  +/-, comparison, or min/max mixing two *known different* units
      (adding ``_w`` to ``_j``). Bare numeric literals are wildcards here
      (epsilon guards like ``maximum(x, 1e-12)`` don't flag).
US03  a binding whose suffix conflicts with the unit inferred from its
      right-hand side, or with its own prefix (``v_a`` claims amperes but
      the ``v_`` prefix promises volts).

Only the four physics modules are checked (see ``TARGETS``). ALL-UPPERCASE
names (module constants like ``C_GATE_PER_UM``, whose trailing token is a
per-unit denominator, not the value's unit) and names shorter than two
tokens are never suffix-typed.
"""
from __future__ import annotations

import ast
from typing import Dict, List, Optional, Tuple

from repro_torch.analysis.astutil import Module, Project, arg_names, dotted
from repro_torch.analysis.findings import Finding

TARGETS = (
    "src/repro_torch/core/characterize.py",
    "src/repro_torch/core/periphery.py",
    "src/repro_torch/core/retention.py",
    "src/repro_torch/hetero/system.py",
)

# dimension vector over (kg, m, s, A, K, bit)
Dim = Tuple[int, int, int, int, int, int]
DIMLESS: Dim = (0, 0, 0, 0, 0, 0)

SUFFIX_DIMS: Dict[str, Dim] = {
    "um2":    (0, 2, 0, 0, 0, 0),
    "um":     (0, 1, 0, 0, 0, 0),
    "s":      (0, 0, 1, 0, 0, 0),
    "hz":     (0, 0, -1, 0, 0, 0),
    "w":      (1, 2, -3, 0, 0, 0),
    "j":      (1, 2, -2, 0, 0, 0),
    "v":      (1, 2, -3, -1, 0, 0),
    "a":      (0, 0, 0, 1, 0, 0),
    "f":      (-1, -2, 4, 2, 0, 0),
    "ohm":    (1, 2, -3, -2, 0, 0),
    "k":      (0, 0, 0, 0, 1, 0),
    "bits":   (0, 0, 0, 0, 0, 1),
    "bits_s": (0, 0, -1, 0, 0, 1),   # matched as a 2-token trailing suffix
}

# quantity prefixes: first name token -> expected dimension
PREFIX_DIMS: Dict[str, Dim] = {
    "t": SUFFIX_DIMS["s"],
    "e": SUFFIX_DIMS["j"],
    "p": SUFFIX_DIMS["w"],
    "f": SUFFIX_DIMS["hz"],
    "i": SUFFIX_DIMS["a"],
    "l": SUFFIX_DIMS["a"],          # leakage currents (l_dec, l_sa, ...)
    "c": SUFFIX_DIMS["f"],
    "r": SUFFIX_DIMS["ohm"],
    "v": SUFFIX_DIMS["v"],
}
# quantity words: an unsuffixed name whose FIRST token is one of these is a
# physics binding by convention even without a single-letter prefix
WORD_DIMS: Dict[str, Dim] = {
    "area":   SUFFIX_DIMS["um2"],
    "delay":  SUFFIX_DIMS["s"],
    "energy": SUFFIX_DIMS["j"],
    "leak":   SUFFIX_DIMS["a"],
}
# names exempt from suffix typing (suffix collides with a non-unit meaning)
NAME_EXEMPT = {"top_k", "self", "cls"}

WILDCARD = "wild"     # numeric literal: compatible with anything in +/-


def suffix_dim(name: str) -> Optional[Dim]:
    """Unit claimed by a name's trailing suffix, or None."""
    if name in NAME_EXEMPT or name.isupper() or name.startswith("_"):
        return None
    tokens = name.split("_")
    if len(tokens) < 2:
        return None
    if len(tokens) >= 3 and "_".join(tokens[-2:]) == "bits_s":
        return SUFFIX_DIMS["bits_s"]
    return SUFFIX_DIMS.get(tokens[-1])


def prefix_dim(name: str) -> Optional[Dim]:
    """Unit promised by a name's quantity prefix/word, or None."""
    if name in NAME_EXEMPT or name.isupper() or name.startswith("_"):
        return None
    tokens = name.split("_")
    if tokens[0] in WORD_DIMS:
        return WORD_DIMS[tokens[0]]
    if len(tokens) >= 2 and tokens[0] in PREFIX_DIMS:
        return PREFIX_DIMS[tokens[0]]
    return None


def _dim_name(d: Dim) -> str:
    for suf, dd in SUFFIX_DIMS.items():
        if dd == d:
            return f"_{suf}"
    if d == DIMLESS:
        return "dimensionless"
    return str(d)


def _combine(a, b, op: str):
    """Dimensional algebra. Values are Dim, WILDCARD, or None (unknown)."""
    if op in ("mul", "div"):
        # literals are dimensionless scale factors here
        aa = DIMLESS if a == WILDCARD else a
        bb = DIMLESS if b == WILDCARD else b
        if aa is None or bb is None:
            return None
        sign = 1 if op == "mul" else -1
        return tuple(x + sign * y for x, y in zip(aa, bb))
    # additive ops: wildcard matches anything
    if a == WILDCARD:
        return b
    if b == WILDCARD:
        return a
    if a is None or b is None:
        return None
    return a if a == b else "mismatch"


_PASSTHROUGH = {"maximum", "minimum", "where", "clip", "abs", "sum", "max",
                "min", "mean", "round", "floor", "ceil", "asarray", "array",
                "diff", "full_like", "zeros_like", "ones_like", "stop_gradient",
                "squeeze", "reshape", "broadcast_to", "select",
                # the torch spellings of the same value-preserving ops
                "clamp", "clamp_min", "clamp_max", "as_tensor", "tensor",
                "amax", "amin", "detach", "contiguous", "expand",
                "unsqueeze", "flatten", "float", "to"}


class _UnitEnv:
    def __init__(self, mod: Module, fn: ast.AST):
        self.mod = mod
        self.fn = fn
        self.env: Dict[str, object] = {}
        self.findings: List[Finding] = []
        for p in arg_names(fn):
            d = suffix_dim(p)
            if d is not None:
                self.env[p] = d

    def _flag(self, rule: str, node: ast.AST, msg: str) -> None:
        self.findings.append(Finding(
            rule, self.mod.rel, node.lineno,
            f"{msg} (in {self.fn.name!r})",
            snippet=self.mod.snippet(node.lineno)))

    # -- inference ---------------------------------------------------------
    def infer(self, node: ast.AST):
        if isinstance(node, ast.Constant):
            if isinstance(node.value, bool):
                return DIMLESS
            if isinstance(node.value, (int, float)):
                return WILDCARD
            return None
        if isinstance(node, ast.Name):
            if node.id in self.env:
                return self.env[node.id]
            return suffix_dim(node.id)
        if isinstance(node, ast.Attribute):
            return suffix_dim(node.attr)
        if isinstance(node, ast.UnaryOp):
            return self.infer(node.operand)
        if isinstance(node, ast.BinOp):
            a, b = self.infer(node.left), self.infer(node.right)
            if isinstance(node.op, ast.Mult):
                return _combine(a, b, "mul")
            if isinstance(node.op, (ast.Div, ast.FloorDiv)):
                return _combine(a, b, "div")
            if isinstance(node.op, (ast.Add, ast.Sub)):
                r = _combine(a, b, "add")
                if r == "mismatch":
                    self._flag("US02", node,
                               f"+/- mixes {_dim_name(a)} with "
                               f"{_dim_name(b)}")
                    return None
                return r
            if isinstance(node.op, ast.Pow) and \
                    isinstance(node.right, ast.Constant) and \
                    isinstance(node.right.value, int):
                if a in (None, WILDCARD):
                    return a
                return tuple(x * node.right.value for x in a)
            return None
        if isinstance(node, ast.Compare):
            vals = [self.infer(node.left)] + [self.infer(c)
                                             for c in node.comparators]
            known = [v for v in vals if v not in (None, WILDCARD)]
            if len(set(known)) > 1:
                self._flag("US02", node,
                           "comparison mixes "
                           + " with ".join(_dim_name(v)
                                           for v in sorted(set(known))))
            return DIMLESS
        if isinstance(node, ast.Subscript):
            # metrics["retention_s"] and friends: the key names the unit
            if isinstance(node.slice, ast.Constant) and \
                    isinstance(node.slice.value, str):
                return suffix_dim(node.slice.value)
            return self.infer(node.value)
        if isinstance(node, ast.IfExp):
            r = _combine(self.infer(node.body), self.infer(node.orelse),
                         "add")
            return None if r == "mismatch" else r
        if isinstance(node, ast.Call):
            callee = dotted(node.func)
            last = callee.split(".")[-1] if callee else ""
            if last in ("maximum", "minimum") and len(node.args) == 2:
                a, b = self.infer(node.args[0]), self.infer(node.args[1])
                r = _combine(a, b, "add")
                if r == "mismatch":
                    self._flag("US02", node,
                               f"{last}() mixes {_dim_name(a)} with "
                               f"{_dim_name(b)}")
                    return None
                return r
            if last == "where" and len(node.args) == 3:
                r = _combine(self.infer(node.args[1]),
                             self.infer(node.args[2]), "add")
                return None if r == "mismatch" else r
            if last == "sqrt" and node.args:
                a = self.infer(node.args[0])
                if isinstance(a, tuple) and all(x % 2 == 0 for x in a):
                    return tuple(x // 2 for x in a)
                return None
            if last in _PASSTHROUGH and node.args:
                return self.infer(node.args[0])
            return None
        return None

    # -- statement walk ----------------------------------------------------
    def _check_target(self, name: str, rhs_dim, node: ast.AST) -> None:
        if name in NAME_EXEMPT or name.isupper() or name.startswith("_"):
            return
        sdim = suffix_dim(name)
        pdim = prefix_dim(name)
        if sdim is not None:
            self.env[name] = sdim
            if pdim is not None and pdim != sdim:
                self._flag("US03", node,
                           f"{name!r}: suffix claims {_dim_name(sdim)} but "
                           f"its prefix promises {_dim_name(pdim)}")
            elif isinstance(rhs_dim, tuple) and rhs_dim != sdim:
                self._flag("US03", node,
                           f"{name!r} claims {_dim_name(sdim)} but its "
                           f"right-hand side is {_dim_name(rhs_dim)}")
            return
        # no suffix on the target
        if pdim is not None:
            self._flag("US01", node,
                       f"{name!r} is a physics binding "
                       f"(expects {_dim_name(pdim)}) but has no unit suffix")
            self.env[name] = pdim
            return
        if isinstance(rhs_dim, tuple) and rhs_dim != DIMLESS:
            self._flag("US01", node,
                       f"{name!r} holds a {_dim_name(rhs_dim)} quantity but "
                       f"has no unit suffix")
            self.env[name] = rhs_dim

    def run(self) -> None:
        for node in ast.walk(self.fn):
            if isinstance(node, ast.Assign):
                if len(node.targets) == 1 and \
                        isinstance(node.targets[0], ast.Name):
                    rhs = self.infer(node.value)
                    self._check_target(node.targets[0].id, rhs, node)
                else:
                    # tuple unpacking: no per-element RHS inference, but
                    # prefix-triggered US01 still applies to each name
                    self.infer(node.value)       # surface US02 inside RHS
                    for t in node.targets:
                        for n in ast.walk(t):
                            if isinstance(n, ast.Name):
                                self._check_target(n.id, None, node)
            elif isinstance(node, ast.AugAssign) and \
                    isinstance(node.target, ast.Name):
                if isinstance(node.op, (ast.Add, ast.Sub)):
                    a = self.infer(node.target)
                    b = self.infer(node.value)
                    if _combine(a, b, "add") == "mismatch":
                        self._flag("US02", node,
                                   f"augmented +/- mixes {_dim_name(a)} "
                                   f"with {_dim_name(b)}")
            elif isinstance(node, ast.Expr):
                self.infer(node.value)           # surface US02 only
            elif isinstance(node, ast.Return) and node.value is not None:
                self.infer(node.value)
            elif isinstance(node, (ast.If, ast.While)):
                self.infer(node.test)


def check(project: Project) -> List[Finding]:
    findings: List[Finding] = []
    for rel in TARGETS:
        mod = project.module(rel)
        if mod is None:
            continue
        for node in ast.walk(mod.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                env = _UnitEnv(mod, node)
                env.run()
                findings.extend(env.findings)
    # nested defs are walked once standalone and once inside their parent;
    # keep the first occurrence of each identical finding
    return list(dict.fromkeys(findings))
