"""End-to-end driver of the PyTorch port: train a qwen3-style LM for a few
hundred steps with the production substrate (AdamW, remat, checkpointing,
fault-tolerant supervisor), as ``examples/train_lm.py`` does through the
JAX package.

One device, no mesh: the JAX driver's sharded AdamW runs on whatever
devices JAX sees; the port's sharded step (``make_train_step(mesh=)``) runs
one process a card under ``torch.distributed`` and is driven by
``python -m repro_torch.launch.train --mesh``, not here.

The backbone is 100M-class once a production-size vocabulary is attached
(~96M tied / 174M untied at vocab 151936 — check with --full-vocab); the
driver ships with vocab 8192 (27.3M params) so 300 steps stay tractable on
one CPU core. Weights come from a ``torch.Generator`` seeded with 0. Runs
on the CUDA device unless ``--device cpu`` is given (without a card the
default raises)::

    PYTHONPATH=src python examples/torch_train_lm.py --steps 300 [--device cpu] [--ckpt-dir DIR]
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.checkpoint.ckpt import Checkpointer
from repro_torch.configs import get_config
from repro_torch.data.pipeline import SyntheticLMData
from repro_torch.device import resolve_device
from repro_torch.optim.adamw import leaves
from repro_torch.runtime.supervisor import Supervisor, SupervisorConfig
from repro_torch.train.step import init_train_state, make_train_step


def build_100m_cfg(full_vocab: bool = False):
    """qwen3-family 100M-class config; reduced vocab keeps the CPU driver
    tractable (embeddings dominate at this scale)."""
    return get_config("qwen3-8b").replace(
        num_layers=6, d_model=512, num_heads=8, num_kv_heads=4, head_dim=64,
        d_ff=1536, vocab_size=151936 if full_vocab else 8192,
        dtype="float32", attn_chunk=128)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default="artifacts/train_lm_ckpt")
    ap.add_argument("--full-vocab", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = build_100m_cfg(full_vocab=args.full_vocab)
    _, step = make_train_step(cfg, base_lr=3e-4, warmup=50,
                              total_steps=args.steps, device=device)
    params, opt = init_train_state(
        cfg, torch.Generator(device=device).manual_seed(0), device=device)
    n = sum(t.numel() for t in leaves(params))
    print(f"model: {n / 1e6:.1f}M params, {cfg.num_layers}L d={cfg.d_model}, "
          f"on {device}")

    data = SyntheticLMData(cfg, args.batch, args.seq, seed=0)
    sup = Supervisor(step, Checkpointer(args.ckpt_dir, keep=2),
                     SupervisorConfig(ckpt_every=100))
    t0 = time.time()
    params, opt, report = sup.run(params, opt, data, total_steps=args.steps)
    dt = time.time() - t0
    losses = report.losses
    print(f"steps={report.steps_run} restarts={report.restarts} "
          f"time={dt:.1f}s ({dt / max(report.steps_run, 1):.2f}s/step)")
    print(f"loss: first10={np.mean(losses[:10]):.4f} "
          f"last10={np.mean(losses[-10:]):.4f}")
    if args.steps >= 50:   # too noisy to judge on smoke-length runs
        if not np.mean(losses[-10:]) < np.mean(losses[:10]):
            raise RuntimeError("loss did not improve")
        print("OK: loss decreased; checkpoint at", args.ckpt_dir)
    return report


if __name__ == "__main__":
    main()
