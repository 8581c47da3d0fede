"""The card's witness of the HS tier: every host sync a hot path makes.

``sync_witness`` runs a block under ``torch.cuda.set_sync_debug_mode("warn")``
and attributes each "synchronizing CUDA operation" warning to the innermost
frame of the port (``src/repro_torch/``, the analyzer excluded) that made it.
``unflagged`` holds those sites to the static tier: a site is flagged when
an HS finding (active, ``# noqa``-suppressed or baselined) lies in the
statement that holds the line; a sync with no frame of the port
(``OUTSIDE``) is never flagged. ``PATHS`` are the hot paths the card checks:
a warm ``explore``, ``compose`` and ``simulate``, and the reduced hymba's
decode step and train step.
"""
from __future__ import annotations

import ast
import collections
import contextlib
import sys
import warnings
from pathlib import Path
from typing import Callable, Dict, List, Tuple

from repro_torch.analysis import host_sync
from repro_torch.analysis.astutil import Project

SYNC_WARNING = "synchronizing CUDA operation"
OUTSIDE = ("<outside the port>", 0)
Site = Tuple[str, int]


def _port_frame(root: Path, frame) -> Site:
    """(repo-relative path, line) of the innermost frame in the port."""
    while frame is not None:
        try:
            rel = Path(frame.f_code.co_filename).resolve().relative_to(
                root).as_posix()
        except ValueError:
            rel = None
        if rel and rel.startswith("src/repro_torch/") and \
                not rel.startswith("src/repro_torch/analysis/"):
            return rel, frame.f_lineno
        frame = frame.f_back
    return OUTSIDE


@contextlib.contextmanager
def sync_witness(root):
    """Record the port site of every synchronizing CUDA operation in the
    block; yields the list of sites (one entry a sync)."""
    import torch
    root = Path(root).resolve()
    sites: List[Site] = []
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        shown = warnings.showwarning

        def hook(message, category, filename, lineno, file=None, line=None):
            if SYNC_WARNING in str(message):
                sites.append(_port_frame(root, sys._getframe(1)))
            else:
                shown(message, category, filename, lineno, file, line)

        warnings.showwarning = hook
        before = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("warn")
        try:
            yield sites
        finally:
            torch.cuda.set_sync_debug_mode(before)


def _statement_span(project: Project, rel: str, line: int) -> Tuple[int, int]:
    """(first, last) line of the innermost statement holding ``line``."""
    mod = project.module(rel)
    best = (line, line)
    if mod is None:
        return best
    size = None
    for node in ast.walk(mod.tree):
        if isinstance(node, ast.stmt) and node.lineno <= line <= (
                node.end_lineno or node.lineno):
            span = (node.end_lineno or node.lineno) - node.lineno
            if size is None or span < size:
                best, size = (node.lineno, node.end_lineno or node.lineno), \
                    span
    return best


def unflagged(project: Project, sites) -> List[Site]:
    """The witnessed sites that no HS finding covers (noqa and baseline
    entries included: they are findings the run suppresses). ``OUTSIDE``,
    a sync with no frame of the port on its stack, is one of them: no line
    of the port can flag it."""
    flagged: Dict[str, List[int]] = collections.defaultdict(list)
    for f in host_sync.check(project):
        flagged[f.path].append(f.line)
    out = []
    for rel, line in sorted(set(sites)):
        if (rel, line) == OUTSIDE:
            out.append(OUTSIDE)
            continue
        first, last = _statement_span(project, rel, line)
        if not any(first <= fl <= last for fl in flagged.get(rel, ())):
            out.append((rel, line))
    return out


# ---------------------------------------------------------------------------
# the hot paths: each () -> a warm callable to witness
# ---------------------------------------------------------------------------


def _compiler(kind: str, dev):
    from repro_torch import api
    from repro_torch.core import gainsight
    task = gainsight.TASKS[0]

    def run():
        if kind == "explore":
            api.explore(device=dev)
        elif kind == "compose":
            api.compose(task=task, device=dev)
        else:
            api.simulate(task=task, device=dev)
    return run


def _reduced_hymba(dev):
    import torch
    from repro_torch.configs import get_config, reduce_config
    from repro_torch.models import LM
    cfg = reduce_config(get_config("hymba-1.5b"))
    lm = LM(cfg, device=dev)
    params = lm.init(torch.Generator(device=dev).manual_seed(0))
    return cfg, lm, params


def _decode(dev):
    import torch
    cfg, lm, params = _reduced_hymba(dev)
    toks = torch.randint(0, cfg.vocab_size, (2, 20),
                         generator=torch.Generator().manual_seed(1))
    cache, _ = lm.prefill(params, {"tokens": toks}, max_seq=32)
    nxt, pos = toks[:, -1], cache["pos"]

    def run():
        lm.decode(params, cache, {"tokens": nxt}, pos=pos)
    return run


def _train(dev):
    import torch
    from repro_torch.configs import get_config, reduce_config
    from repro_torch.data.pipeline import SyntheticLMData
    from repro_torch.train.step import init_train_state, make_train_step
    cfg = reduce_config(get_config("hymba-1.5b"))
    _, step = make_train_step(cfg, warmup=2, total_steps=8, device=dev)
    params, opt = init_train_state(cfg, torch.Generator(device=dev)
                                   .manual_seed(0), device=dev)
    batch = SyntheticLMData(cfg, 2, 68, 0).next_batch()
    state = {"params": params, "opt": opt, "i": 1}

    def run():
        state["params"], state["opt"], _ = step(
            state["params"], state["opt"], batch, state["i"])
        state["i"] += 1
    return run


PATHS: Dict[str, Callable] = {
    "explore": lambda dev: _compiler("explore", dev),
    "compose": lambda dev: _compiler("compose", dev),
    "simulate": lambda dev: _compiler("simulate", dev),
    "decode": _decode,
    "train": _train,
}


def witness_path(root, make, dev) -> List[Site]:
    """The syncs of one warm call of a path (one unwitnessed call first)."""
    import torch
    run = make(dev)
    run()
    torch.cuda.synchronize(dev)
    with sync_witness(root) as sites:
        run()
    torch.cuda.synchronize(dev)
    return sites
