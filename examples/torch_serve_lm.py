"""Serving example of the PyTorch port: batched prefill + decode with KV
cache on a reduced hymba (hybrid attention+SSM) model — exercises ring/SWA
caches and SSM state, as ``examples/serve_lm.py`` does through the JAX
package. On the card every attention layer runs the flash-attention kernel
and every SSM head the scan kernel (the launches are printed).

The weights come from a ``torch.Generator`` seeded with 0; temperature
sampling draws from the ``torch.Generator`` that ``Engine.generate`` seeds
with ``seed=0``. Runs on the CUDA device unless ``--device cpu`` is given
(without a card the default raises)::

    PYTHONPATH=src python examples/torch_serve_lm.py [--device cpu]
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config, reduce_config
from repro_torch.device import resolve_device
from repro_torch.kernels import flash_attention as kflash
from repro_torch.kernels import ssm_scan as kssm
from repro_torch.models import LM
from repro_torch.serve.engine import Engine


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = reduce_config(get_config("hymba-1.5b"))
    params = LM(cfg, device).init(
        torch.Generator(device=device).manual_seed(0))
    eng = Engine(cfg, params, max_seq=96, device=device)

    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (4, 12)).astype(np.int32)}
    launches0 = (kflash.flash_attention.launches, kssm.ssm_scan.launches)
    t0 = time.time()
    out = eng.generate(batch, steps=24, temperature=0.8, seed=0)
    dt = time.time() - t0
    launches = (kflash.flash_attention.launches - launches0[0],
                kssm.ssm_scan.launches - launches0[1])
    print(f"generated {out.shape} tokens in {dt:.2f}s "
          f"({out.size / dt:.1f} tok/s, batched, ring+SSM caches)")
    for i, row in enumerate(out[:2]):
        print(f"  request {i}: {row[:16].tolist()} ...")
    print(f"kernel launches on {device}: flash_attention {launches[0]}, "
          f"ssm_scan {launches[1]}")
    same = np.array_equal(eng.generate(batch, steps=8),
                          eng.generate(batch, steps=8))
    print("greedy determinism check:", same)
    return {"tokens": out, "deterministic": same,
            "launches": {"flash_attention": launches[0],
                         "ssm_scan": launches[1]}}


if __name__ == "__main__":
    main()
