"""Training launcher: the supervised training loop with checkpoints and
resumable data.

    PYTHONPATH=src python -m repro_torch.launch.train --arch hymba-1.5b \
        --reduced --steps 100 --batch 8 --seq 64

Runs on the CUDA device unless ``--device cpu`` is given. ``--seq`` counts
the meta tokens too (the data pipeline's ``seq_len``). Weights are random,
drawn from a ``torch.Generator`` seeded with 0; the data stream from seed
0. The flags and the two closing lines are the reference launcher's
(``repro/launch/train.py``).

``--mesh DxM`` trains sharded over a ("data", "model") mesh of D x M
processes started by ``torchrun`` (one a card, NCCL; gloo with ``--device
cpu``), every rank drawing the same weights and batches:

    torchrun --nproc-per-node 4 -m repro_torch.launch.train --mesh 2x2 ...

Checkpoints are then written by rank 0 and restored onto the mesh, and
only rank 0 prints.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.checkpoint.ckpt import Checkpointer
from repro_torch.configs import get_config, list_archs, reduce_config
from repro_torch.data.pipeline import SyntheticLMData
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import make_mesh
from repro_torch.runtime.supervisor import Supervisor, SupervisorConfig
from repro_torch.train.step import init_train_state, make_train_step


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="hymba-1.5b", choices=list_archs())
    ap.add_argument("--reduced", action="store_true",
                    help="reduced config (CPU-scale)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--microbatch", type=int, default=None)
    ap.add_argument("--ckpt-dir", default="artifacts/launch_train_ckpt")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--mesh", default=None, metavar="DxM",
                    help="train sharded on a (data, model) mesh of D x M "
                         "processes (torchrun)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduce_config(cfg)
    if args.seq <= (cfg.meta_tokens or 0) + 1:
        ap.error(f"--seq {args.seq} leaves no text after {cfg.meta_tokens} "
                 f"meta tokens")
    mesh = None
    if args.mesh:
        try:
            shape = tuple(int(n) for n in args.mesh.lower().split("x"))
        except ValueError:
            shape = ()
        if len(shape) != 2:
            ap.error(f"--mesh takes DxM, got {args.mesh!r}")
        mesh = make_mesh(shape, ("data", "model"), args.device)
        device = torch.device(mesh.device_type, torch.cuda.current_device()) \
            if mesh.device_type == "cuda" else torch.device("cpu")
    else:
        device = resolve_device(args.device)
    _, step = make_train_step(cfg, base_lr=args.lr, warmup=20,
                              total_steps=args.steps,
                              microbatch=args.microbatch, device=device,
                              mesh=mesh)
    params, opt = init_train_state(
        cfg, torch.Generator(device=device).manual_seed(0), device=device,
        mesh=mesh)
    data = SyntheticLMData(cfg, args.batch, args.seq, seed=0)
    lead = mesh is None or torch.distributed.get_rank() == 0
    ck = Checkpointer(args.ckpt_dir, keep=2)
    start = 0
    if args.resume and ck.latest_step() is not None:
        start, params, opt, dstate = ck.restore(params_template=params,
                                                opt_template=opt)
        data.state.seed, data.state.step = dstate["seed"], dstate["step"]
        if lead:
            print(f"resumed from step {start}")

    sup = Supervisor(step, ck, SupervisorConfig(ckpt_every=args.ckpt_every))
    params, opt, report = sup.run(params, opt, data, total_steps=args.steps,
                                  start_step=start)
    if lead:
        if mesh is not None:
            print(f"mesh={tuple(mesh.shape)} {mesh.mesh_dim_names} "
                  f"{mesh.device_type}")
        print(f"arch={args.arch} steps={report.steps_run} "
              f"restarts={report.restarts} stragglers="
              f"{len(report.straggler_events)}")
        print(f"loss first10={np.mean(report.losses[:10]):.4f} "
              f"last10={np.mean(report.losses[-10:]):.4f}")
    if mesh is not None:
        torch.distributed.destroy_process_group()
    return report


if __name__ == "__main__":
    main()
