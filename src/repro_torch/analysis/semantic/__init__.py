"""The port analyzer's semantic tier: LG / DT / RC.

Unlike the AST tier this package imports torch, drives the entry points and,
on a card, launches every CUDA library in guarded buffers. It is loaded
lazily: ``python -m repro_torch.analysis`` pulls it in only for
``--semantic`` (or ``--rules`` naming one of its families), and its modules
import torch inside their functions.
"""
from __future__ import annotations

from repro_torch.analysis.semantic import dt, lg, rc

CHECKERS = {
    "LG": lg.check,
    "DT": dt.check,
    "RC": rc.check,
}

__all__ = ["CHECKERS", "lg", "dt", "rc"]
