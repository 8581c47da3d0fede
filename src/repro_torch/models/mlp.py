"""Feed-forward blocks: SwiGLU (the llama family, hymba, the MoE experts)
and the non-gated GELU block (granite, musicgen), as
``repro/models/mlp.py``."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.common import dense_init


def init_mlp(gen, d_model, d_ff, mlp_type, dtype, device):
    if mlp_type == "swiglu":
        return {
            "wg": dense_init(gen, (d_model, d_ff), dtype, device),
            "wu": dense_init(gen, (d_model, d_ff), dtype, device),
            "wd": dense_init(gen, (d_ff, d_model), dtype, device),
        }
    return {
        "wi": dense_init(gen, (d_model, d_ff), dtype, device),
        "wd": dense_init(gen, (d_ff, d_model), dtype, device),
    }


def mlp_block(p, x: torch.Tensor) -> torch.Tensor:
    if "wg" in p:
        g = x @ p["wg"]
        u = x @ p["wu"]
        h = F.silu(g.float()).to(x.dtype) * u
    else:
        # jax.nn.gelu's default is the tanh approximation
        h = F.gelu((x @ p["wi"]).float(), approximate="tanh").to(x.dtype)
    return h @ p["wd"]
