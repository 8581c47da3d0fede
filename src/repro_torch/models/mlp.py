"""Feed-forward blocks: SwiGLU (the llama family, hymba, the MoE experts)
and the non-gated GELU block (granite, musicgen), as
``repro/models/mlp.py``.

Under an active mesh whose "model" axis divides d_ff, the block is tensor
parallel: each rank of "model" computes its d_ff columns of the up
products and its rows of the down product, and the partial outputs are
all-reduced over "model" (``parallel.comm``); without a mesh the calls
are the identity."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.common import dense_init
from repro_torch.parallel import comm


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
    if p["wd"].shape[0] % comm.axis_size("model"):
        return _mlp(p, x)
    x = comm.enter(x, "model")
    local = {k: comm.split(w, 0 if k == "wd" else 1, "model")
             for k, w in p.items()}
    return comm.reduce(_mlp(local, x), "model")


def _mlp(p, x: torch.Tensor) -> torch.Tensor:
    if "wg" in p:
        g = x @ p["wg"]
        u = x @ p["wu"]
        h = F.silu(g.float()).to(x.dtype) * u
    else:
        # jax.nn.gelu's default is the tanh approximation
        h = x @ p["wi"]
        h = F.gelu(h.float(), approximate="tanh").to(x.dtype)
    return h @ p["wd"]
