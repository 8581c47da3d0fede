"""RC: what the port compiles, against its budget (semantic tier).

The JAX package meters jit trace caches. The port has no trace cache and no
``torch.compile``: what it compiles is the five CUDA libraries, each built
once by ``kernels.build`` (counted in the ``kernels.builds`` counter; a
library already on disk under the same source-and-flags key is loaded, not
built).

  RC01  (card) driving every entry point (``DRIVERS``) once built a library
        more than once, or more libraries than ``LAUNCH_ARGTYPES`` holds;
        also checked over the whole process (``process_builds``)
  RC02  (card) a repeat drive of the same entry points built or loaded a
        library again: the build key or the load cache is unstable
  RC03  (static) a ``torch.compile`` / ``torch.jit`` site in the port with no
        entry in ``BUDGETS`` (there is none today)
  RC04  a driver failed on either drive, or a budgeted site no longer
        exists

On a machine without a card the drive launches nothing, so RC01 / RC02 run
only on the card; RC03 runs everywhere.
"""
from __future__ import annotations

import ast
import time
from pathlib import Path
from typing import Callable, Dict, List, Tuple

from repro_torch.analysis import astutil
from repro_torch.analysis.findings import Finding

PKG = "src/repro_torch"
RC_REL = "src/repro_torch/analysis/semantic/rc.py"
# (module, name) of each torch.compile / torch.jit site -> the compiles it
# may make; the port has none
BUDGETS: Dict[Tuple[str, str], int] = {}
_COMPILE_CALLS = {"torch.compile", "torch.jit.script", "torch.jit.trace",
                  "torch.jit.trace_module", "torch.compiler.compile"}


def compile_sites(project) -> List[Tuple[str, str, int]]:
    """(module, enclosing name, line) of every torch.compile / torch.jit
    call or decorator in the port."""
    out = []
    for mod in project.iter_modules(PKG):
        aliases = astutil.import_aliases(mod.tree)

        def full(node):
            d = astutil.dotted(node.func if isinstance(node, ast.Call)
                               else node)
            if d is None:
                return None
            head, _, rest = d.partition(".")
            return aliases.get(head, head) + ("." + rest if rest else "")

        for top in ast.walk(mod.tree):
            if isinstance(top, (ast.FunctionDef, ast.AsyncFunctionDef,
                                ast.ClassDef)):
                for dec in top.decorator_list:
                    if full(dec) in _COMPILE_CALLS:
                        out.append((mod.rel, top.name, top.lineno))
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.Call) and full(node) in _COMPILE_CALLS:
                out.append((mod.rel, "<call>", node.lineno))
    return sorted(set(out))


# ---------------------------------------------------------------------------
# drivers: every entry point, small, on the card
# ---------------------------------------------------------------------------


def _drive_compiler(dev) -> None:
    """explore, compose, simulate and the sizing, each once."""
    from repro_torch import api
    from repro_torch.core import gainsight
    from repro_torch.hetero import ComposePolicy
    space = api.design_space(word_sizes=(32,), num_words=(64, 128))
    task = gainsight.TASKS[0]
    api.explore(space, tasks=[task], device=dev)
    api.compose(space, task, compose_policy=ComposePolicy(top_k=4),
                device=dev)
    api.simulate(space, task, compose_policy=ComposePolicy(top_k=4),
                 device=dev)
    api.gradient_size_macro(api.MacroConfig(), steps=2, device=dev)


def _drive_models(dev) -> None:
    """The reduced hymba served (prefill, decode) and one train step."""
    import torch
    from repro_torch.configs import get_config, reduce_config
    from repro_torch.data.pipeline import SyntheticLMData
    from repro_torch.models import LM
    from repro_torch.serve.engine import Engine
    from repro_torch.train.step import init_train_state, make_train_step
    cfg = reduce_config(get_config("hymba-1.5b"))
    params = LM(cfg, device=dev).init(torch.Generator(device=dev)
                                      .manual_seed(0))
    toks = torch.randint(0, cfg.vocab_size, (2, 20),
                         generator=torch.Generator().manual_seed(1))
    Engine(cfg, params, max_seq=32, device=dev).generate({"tokens": toks},
                                                         steps=4)
    _, step = make_train_step(cfg, warmup=2, total_steps=4, device=dev)
    params, opt = init_train_state(cfg, torch.Generator(device=dev)
                                   .manual_seed(0), device=dev)
    step(params, opt, SyntheticLMData(cfg, 2, 68, 0).next_batch(), 1)


DRIVERS: Tuple[Callable, ...] = (_drive_compiler, _drive_models)


def build_counts() -> Tuple[int, int]:
    """(libraries built, libraries loaded) by this process so far."""
    from repro_torch.kernels import build
    return build.BUILDS.value, build.load.cache_info().misses


def process_builds(since: float) -> Dict[str, int]:
    """Libraries written into the build directory since ``since`` (a
    ``time.time()``), by name: more than one for a name means it was built
    twice under different keys."""
    from repro_torch.kernels import build
    out: Dict[str, int] = {}
    for lib in Path(build.BUILD_DIR).glob("*.so"):
        if lib.stat().st_mtime >= since:
            name = lib.stem.rsplit("_", 1)[0]
            out[name] = out.get(name, 0) + 1
    return out


def audit_builds(device, drivers=None):
    """Drive every entry point twice on ``device``: returns ((built,
    loaded) by the first drive, (built, loaded) by the repeat, driver
    errors)."""
    drivers = DRIVERS if drivers is None else drivers
    errors = []
    counts = [build_counts()]
    for which in ("first", "repeat"):
        for drive in drivers:
            try:
                drive(device)
            except Exception as e:  # a failed driver is a finding (RC04)
                errors.append(f"driver {drive.__name__} failed on the "
                              f"{which} drive: {type(e).__name__}: {e}")
        counts.append(build_counts())
    b0, b1, b2 = counts
    return ((b1[0] - b0[0], b1[1] - b0[1]), (b2[0] - b1[0], b2[1] - b1[1]),
            errors)


def check(project, device=None, since: float = None) -> List[Finding]:
    import torch
    from repro_torch.analysis import kernel_cov
    findings: List[Finding] = []

    def emit(rule, rel, line, snippet, msg):
        findings.append(Finding(rule=rule, path=rel, line=line, message=msg,
                                snippet=snippet))

    for rel, name, line in compile_sites(project):
        if (rel, name) not in BUDGETS:
            mod = project.module(rel)
            emit("RC03", rel, line, mod.snippet(line) if mod else "",
                 f"torch.compile / torch.jit site in {name!r} has no "
                 f"budget in repro_torch.analysis.semantic.rc.BUDGETS")
    for (rel, name) in BUDGETS:
        if not any(r == rel and n == name
                   for r, n, _ in compile_sites(project)):
            emit("RC04", rel, 0, name, f"budgeted compile site {name!r} "
                                       f"no longer exists")
    if device is None and not torch.cuda.is_available():
        return findings
    n_libs = len(kernel_cov.libraries(project)[0])
    first, repeat, errors = audit_builds(torch.device(device or "cuda"))
    for why in errors:
        emit("RC04", RC_REL, 0, why.split(":")[0], why)
    if first[0] > n_libs:
        emit("RC01", RC_REL, 0, "first drive",
             f"the first drive built {first[0]} libraries, budget {n_libs}")
    if repeat != (0, 0):
        emit("RC02", RC_REL, 0, "repeat drive",
             f"the repeat drive built {repeat[0]} and loaded {repeat[1]} "
             f"libraries again")
    for name, n in sorted(process_builds(
            time.time() if since is None else since).items()):
        if n > 1:
            emit("RC01", RC_REL, 0, f"process:{name}",
                 f"{name} was built {n} times in this process")
    return findings
