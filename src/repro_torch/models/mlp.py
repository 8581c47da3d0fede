"""Feed-forward block: SwiGLU (the llama family and hymba). The non-gated
GELU block of the reference (granite, musicgen) is not ported yet."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.common import dense_init


def init_mlp(gen, d_model, d_ff, mlp_type, dtype, device):
    if mlp_type != "swiglu":
        raise NotImplementedError(
            f"mlp_type {mlp_type!r}: only swiglu is ported (ROADMAP.md, "
            f"queue 1: the other LM families)")
    return {
        "wg": dense_init(gen, (d_model, d_ff), dtype, device),
        "wu": dense_init(gen, (d_model, d_ff), dtype, device),
        "wd": dense_init(gen, (d_ff, d_model), dtype, device),
    }


def mlp_block(p, x: torch.Tensor) -> torch.Tensor:
    g = x @ p["wg"]
    u = x @ p["wu"]
    h = F.silu(g.float()).to(x.dtype) * u
    return h @ p["wd"]
