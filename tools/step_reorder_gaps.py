#!/usr/bin/env python3
"""How far two correct orders of one training step lie apart, at the full
width of hymba-1.5b, by depth and dtype: the noise floor that a sharded
step's gap to one device is read against.

    python3 tools/step_reorder_gaps.py [--depths 1 2 4 8] [--dtypes
        bfloat16 float32] [--batch 4] [--seq 192] [--device cpu]
        [--sharded-depths 1 2] [--out FILE]

For each depth and dtype, on one device (the plain PyTorch path on the
CPU, the kernels on the card), from the weights of seed 0 and the first
batch of data seed 0, the loss and its gradient of ``LM.loss`` are taken
two ways that differ only in the order of their sums: ``whole``, the
batch at once, and ``micro``, the batch in 2 halves, their gradients
added in float32. It prints, as JSON lines, the gap of ``micro`` to
``whole`` as the sharded gates read it: the loss and grad_norm
relative, and for the gradient the largest over the leaves of max|a - b|
/ max|b| (the first AdamW moment's gap after a step at lr 0, since m =
(1 - beta1) g / max(1, grad_norm)), with the leaf that has it. In
bfloat16 it also gives the gap of the bfloat16 gradient to the float32
one of the same weights (``bf16_vs_f32``).

At each of ``--sharded-depths`` (CPU only) the case also runs the sharded
step on a gloo ("data", "model") = (2, 2) mesh of 4 processes against one
process (``tests/torch_sharded_checks.train_check``'s gaps after a step
at lr 0, the same definitions; m is the gradient's column). A gap that
grows with depth at one rate in every column is rounding carried through
the layers; a fault of the sharded step shows in its column alone.
"""
from __future__ import annotations

import argparse
import json
import math
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT / "tests"))


def _grads(lm, params, batch, flat):
    import torch
    loss, _ = lm.loss(params, batch, remat="none")
    g = torch.autograd.grad(loss, flat, allow_unused=True,
                            materialize_grads=True)
    return float(loss), [t.detach().float() for t in g]


def _gaps(got, want, names):
    """(loss, grad_norm, grad, worst leaf) of (loss, grads) ``got`` to
    ``want``."""
    (la, ga), (lb, gb) = got, want
    na = math.sqrt(sum(float(g.double().square().sum()) for g in ga))
    nb = math.sqrt(sum(float(g.double().square().sum()) for g in gb))
    worst, leaf = 0.0, None
    for name, a, b in zip(names, ga, gb):
        den = float(b.abs().max())
        if not den:
            continue
        gap = float((a.double() - b.double()).abs().max()) / den
        if gap > worst:
            worst, leaf = gap, name
    return {"loss": abs(la - lb) / abs(lb), "grad_norm": abs(na - nb) / nb,
            "grad": worst, "worst": leaf}


def one_device(depth, dtype, batch_size, seq, device):
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import SyntheticLMData
    from repro_torch.models import LM
    from repro_torch.optim.adamw import leaves, tree_map
    from repro_torch.parallel.sharding import flatten_with_path
    cfg = get_config("hymba-1.5b").replace(num_layers=depth, dtype=dtype)
    lm = LM(cfg, device)
    params = lm.init(torch.Generator(device=lm.device).manual_seed(0))
    batch = {k: torch.as_tensor(v).to(lm.device) for k, v in
             SyntheticLMData(cfg, batch_size, seq, 0).next_batch().items()}
    names = ["/".join(map(str, k)) for k, _ in flatten_with_path(params)]
    flat = leaves(params)
    for t in flat:
        t.requires_grad_(True)
    whole = _grads(lm, params, batch, flat)
    half = batch_size // 2
    a = _grads(lm, params, {k: v[:half] for k, v in batch.items()}, flat)
    b = _grads(lm, params, {k: v[half:] for k, v in batch.items()}, flat)
    micro = ((a[0] + b[0]) / 2, [(x + y) / 2 for x, y in zip(a[1], b[1])])
    row = {"depth": depth, "dtype": dtype, "device": str(lm.device),
           "batch": batch_size, "seq": seq, "grad_norm_whole": math.sqrt(
               sum(float(g.double().square().sum()) for g in whole[1])),
           "micro": _gaps(micro, whole, names)}
    if dtype == "bfloat16":
        f32 = LM(cfg.replace(dtype="float32"), device)
        with torch.no_grad():
            p32 = tree_map(lambda p: p.float().requires_grad_(True), params)
        row["bf16_vs_f32"] = _gaps(whole, _grads(f32, p32, batch,
                                                 leaves(p32)), names)
    return row


def sharded(depth, dtype, batch_size, seq):
    import torch_sharded_checks as checks
    from repro_torch.launch import spmd
    spec = dict(arch="hymba-1.5b", mesh=(2, 2), batch=batch_size, seq=seq,
                overrides={"num_layers": depth, "dtype": dtype},
                data_seed=0, seed=0, base_lr=1e-3, warmup=2, steps=[0],
                single=True)
    out = spmd.launch(spmd.run_all, 4, ([(checks.train_check, spec)],),
                      device="cpu", timeout=1800)[0][0]
    g = out["gaps"]
    return {"loss": g["loss"], "grad_norm": g["grad_norm"], "m": g["m"],
            "v": g["v"], "worst": g["worst"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--depths", type=int, nargs="+", default=[1, 2, 4, 8])
    ap.add_argument("--dtypes", nargs="+", default=["bfloat16", "float32"],
                    choices=["bfloat16", "float32"])
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=192,
                    help="tokens a row, hymba's 128 meta tokens included")
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--sharded-depths", type=int, nargs="*", default=[],
                    help="depths that also run the gloo (2, 2) sharded "
                         "step (CPU only)")
    ap.add_argument("--out", default=None, help="append the rows here too")
    args = ap.parse_args(argv)
    if args.sharded_depths and args.device != "cpu":
        ap.error("--sharded-depths runs gloo processes on the CPU")
    import torch
    if args.device == "cpu":
        torch.set_num_threads(min(8, torch.get_num_threads()))
    for dtype in args.dtypes:
        for depth in args.depths:
            t0 = time.perf_counter()
            row = one_device(depth, dtype, args.batch, args.seq,
                             args.device)
            if depth in args.sharded_depths:
                row["sharded"] = sharded(depth, dtype, args.batch, args.seq)
            row["s"] = time.perf_counter() - t0
            line = json.dumps(row)
            print(line, flush=True)
            if args.out:
                with open(args.out, "a") as f:
                    f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
