"""Quick smoke of the PyTorch port: every arch, reduced config, one loss
eval + prefill/decode, as ``scripts/smoke_models.py`` does for the JAX
package.

    PYTHONPATH=src python scripts/smoke_models_torch.py [--device cpu] [arch ...]

Runs on the CUDA device unless ``--device cpu`` is given (without a card
the default raises). Weights are random, drawn from a ``torch.Generator``
seeded with 0 on the device; the batches come from numpy's
``default_rng(0)``, drawn arch after arch as the JAX script draws them.
Exits non-zero if a loss or a decode logit is not finite, and, on the card,
if an attention or scan call took its plain version
(``kernels.dispatch.<op>.plain``) instead of the kernel.
"""
import argparse
import math
import sys

import numpy as np
import torch

from repro_torch import obs
from repro_torch.configs import ALL_ARCHS, get_config, reduce_config
from repro_torch.device import resolve_device
from repro_torch.models import LM
from repro_torch.optim.adamw import leaves

# the kernel wrappers' plain-route counters: on the card they must not move
PLAIN_ROUTES = ("kernels.dispatch.flash_attention.plain",
                "kernels.dispatch.ssm_scan.plain")


def make_batch(cfg, rng, B=2, S=32):
    """The JAX script's batch: the same numpy arrays from the same draws."""
    if cfg.audio_codebooks:
        return {"codes": rng.integers(0, cfg.vocab_size, (B, cfg.audio_codebooks, S)).astype(np.int32),
                "cond": rng.normal(size=(B, cfg.cond_len, cfg.cond_dim)).astype(np.float32)}
    if cfg.vision:
        return {"tokens": rng.integers(0, cfg.vocab_size, (B, S - cfg.num_patches)).astype(np.int32),
                "patches": rng.normal(size=(B, cfg.num_patches, cfg.vision_dim)).astype(np.float32)}
    if cfg.meta_tokens:
        return {"tokens": rng.integers(0, cfg.vocab_size, (B, S - cfg.meta_tokens)).astype(np.int32)}
    return {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}


@torch.no_grad()
def check(cfg, params, batch, device):
    """One loss, a prefill (max_seq 48) and one decode step of ``cfg`` with
    ``params`` on ``device``. Returns {"params", "loss", "finite",
    "decode_finite", "logits" (the decode logits' shape)}."""
    lm = LM(cfg, device)
    loss, _ = lm.loss(params, batch)
    loss = float(loss)
    cache, _ = lm.prefill(params, batch, max_seq=48)
    dec_in = {"tokens": np.zeros((2, cfg.audio_codebooks), np.int32)
              if cfg.audio_codebooks else np.zeros((2,), np.int32)}
    if cfg.audio_codebooks:
        dec_in["cond"] = batch["cond"]
    logits, _ = lm.decode(params, cache, dec_in)
    return {"params": sum(t.numel() for t in leaves(params)), "loss": loss,
            "finite": math.isfinite(loss),
            "decode_finite": bool(torch.isfinite(logits).all()),
            "logits": tuple(logits.shape)}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("archs", nargs="*", metavar="arch",
                    help=f"any of {ALL_ARCHS} (default: all)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    rng = np.random.default_rng(0)
    plain0 = {c: obs.value(c) for c in PLAIN_ROUTES}
    bad = []
    for name in args.archs or ALL_ARCHS:
        cfg = reduce_config(get_config(name))
        params = LM(cfg, device).init(
            torch.Generator(device=device).manual_seed(0))
        r = check(cfg, params, make_batch(cfg, rng), device)
        print(f"{name:24s} params={r['params']:9d} loss={r['loss']:8.4f} "
              f"finite={r['finite']} decode_finite={r['decode_finite']} "
              f"logits={r['logits']}", flush=True)
        if not (r["finite"] and r["decode_finite"]):
            bad.append(name)
    plain = {c: obs.value(c) - v for c, v in plain0.items()}
    if device.type == "cuda" and any(plain.values()):
        print(f"plain versions ran on the card: {plain}", file=sys.stderr)
        return 1
    if bad:
        print(f"not finite: {bad}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
