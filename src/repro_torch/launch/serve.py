"""Serving launcher: batched generation with the production cache stack.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch hymba-1.5b \
        --requests 4 --prompt-len 1000 --steps 32 --max-seq 1040
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch deepseek-v3-671b --layers 4 --prompt-len 1000 --max-seq 1040
    PYTHONPATH=src python -m repro_torch.launch.serve --arch musicgen-medium \
        --reduced --device cpu

Serves any registered configuration but a vision one, which takes image
patches the launcher does not make (as the reference's launcher makes
none): serve it through ``Engine.generate`` with a ``patches`` batch. Runs
on the CUDA device unless ``--device cpu`` is given; ``--reduced`` takes
the configuration's CPU-scale version and ``--layers`` keeps its first
layers (deepseek-v3-671b whole does not fit one card). Weights are random,
drawn from a ``torch.Generator`` seeded with ``--seed``; the prompts (an
audio model's codes and its normal condition) come from numpy's generator
with the same seed.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config, list_archs, reduce_config
from repro_torch.device import resolve_device
from repro_torch.models import LM
from repro_torch.serve.engine import Engine


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="hymba-1.5b", choices=list_archs())
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--layers", type=int, default=None,
                    help="keep the first LAYERS layers (default: all)")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=12)
    ap.add_argument("--steps", type=int, default=24)
    ap.add_argument("--temperature", type=float, default=None)
    ap.add_argument("--max-seq", type=int, default=128)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if cfg.vision:
        ap.error(f"{args.arch} takes image patches, which this launcher does "
                 f"not make (nor does the reference's): serve it through "
                 f"Engine.generate with a batch holding 'patches'")
    if args.reduced:
        cfg = reduce_config(cfg)
    if args.layers is not None:
        cfg = cfg.replace(num_layers=args.layers)
    device = resolve_device(args.device)
    lm = LM(cfg, device)
    params = lm.init(torch.Generator(device=device).manual_seed(args.seed))
    eng = Engine(cfg, params, max_seq=args.max_seq, device=device)
    rng = np.random.default_rng(args.seed)
    if cfg.audio_codebooks:
        batch = {"codes": rng.integers(0, cfg.vocab_size,
                                       (args.requests, cfg.audio_codebooks,
                                        args.prompt_len)).astype(np.int32),
                 "cond": rng.normal(size=(args.requests, cfg.cond_len,
                                          cfg.cond_dim)).astype(np.float32)}
    else:
        batch = {"tokens": rng.integers(0, cfg.vocab_size,
                                        (args.requests, args.prompt_len)
                                        ).astype(np.int32)}

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    sync()
    t0 = time.perf_counter()
    out = eng.generate(batch, steps=args.steps, temperature=args.temperature,
                       seed=args.seed)
    sync()
    dt = time.perf_counter() - t0
    print(f"{args.arch} on {device}: generated {out.shape} in {dt:.2f}s "
          f"({out.size / dt:.1f} tok/s)")
    return out


if __name__ == "__main__":
    main()
