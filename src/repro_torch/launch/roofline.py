"""Roofline of the dry-run records: the reference's ``launch/roofline.py``.

Three terms per (arch x shape x mesh), with the constants of the TPU-v5e-
class chip the memory DSE designs for (not the H100's):

    compute    = FLOPs / (chips * 197 TFLOP/s)
    memory     = HBM bytes / (chips * 819 GB/s)
    collective = collective bytes / (chips * 50 GB/s per link)

FLOPs and HBM bytes come from the analytic cost model below; collective
bytes from the record. ``MODEL_FLOPS`` = 6·N_active·D (train) or
2·N_active·D (inference) stands beside the executed-FLOPs estimate; their
ratio shows the remat recompute and the blocked attention's masked work.
Every number is a Python float computed in the reference's order of
operations, so a record gives the reference's row bit for bit.

    python -m repro_torch.launch.roofline [--mesh pod16x16] [--out DIR]
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import Dict, Optional

from repro_torch.configs import SHAPES, get_config

PEAK_FLOPS = 197e12        # bf16 / chip
HBM_BW = 819e9             # B/s / chip
LINK_BW = 50e9             # B/s / link


def _attn_dims(cfg):
    if cfg.mla:
        return cfg.qk_nope_dim + cfg.qk_rope_dim, cfg.v_head_dim
    return cfg.head_dim, cfg.head_dim


def analytic_cost(arch: str, shape_name: str, params_total: int,
                  params_active: int) -> Dict[str, float]:
    """Global executed FLOPs + HBM bytes for one cell (whole mesh)."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    B, S = shape.global_batch, shape.seq_len
    L, H = cfg.num_layers, cfg.num_heads
    dqk, dv = _attn_dims(cfg)
    di = cfg.d_model * cfg.ssm_expand
    n_full = len(cfg.full_attn_every) if cfg.full_attn_every else (
        L if cfg.family != "ssm" else 0)
    n_swa = L - n_full if cfg.family == "hybrid" else 0

    tokens = B * S if shape.kind in ("train", "prefill") else B
    matmul_fwd = 2.0 * params_active * tokens

    if shape.kind in ("train", "prefill"):
        # blocked attention computes full (not triangular) S^2 per layer
        attn = 2.0 * B * S * S * H * (dqk + dv) * n_full
        attn += 2.0 * B * S * min(cfg.window, S) * H * (dqk + dv) * n_swa
        ssm = 6.0 * B * S * di * cfg.ssm_state * (
            L if cfg.family == "hybrid" else 0)
        if cfg.family == "ssm":
            dh = 2 * cfg.d_model // cfg.num_heads
            ssm = 4.0 * B * S * cfg.num_heads * dh * dh * L  # mLSTM C update
        fwd = matmul_fwd + attn + ssm
        # train: fwd + backward (2x) + the full remat's recompute (+1 fwd)
        flops = 4.0 * fwd if shape.kind == "train" else fwd
    else:  # decode: one token against an S-length cache
        cache_len = S
        if cfg.family == "hybrid":
            attn = 2.0 * B * (cache_len * n_full + min(cfg.window, cache_len)
                              * n_swa) * H * (dqk + dv)
        elif cfg.family == "ssm":
            dh = 2 * cfg.d_model // cfg.num_heads
            attn = 4.0 * B * cfg.num_heads * dh * dh * L
        elif cfg.mla:
            # absorbed decode: scores + output against the latent cache
            attn = 2.0 * B * cache_len * H * (cfg.kv_lora_rank * 2
                                              + cfg.qk_rope_dim) \
                + 2.0 * B * H * (cfg.qk_nope_dim * cfg.kv_lora_rank
                                 + cfg.kv_lora_rank * cfg.v_head_dim)
        else:
            attn = 2.0 * B * cache_len * H * (dqk + dv) * 1.0
            attn *= L
        if cfg.mla:
            attn *= L
        flops = matmul_fwd + attn
        if cfg.family == "hybrid":
            flops += 6.0 * B * di * cfg.ssm_state * L

    # --- HBM bytes ---------------------------------------------------------
    p_bytes = 2.0 * params_active          # bf16 stream of active params
    d = cfg.d_model
    if shape.kind == "train":
        # params fwd + bwd + grads + fp32 opt m/v read+write + param write
        hbm = 2.0 * params_total * 2 + 2.0 * params_total \
            + 16.0 * params_total + 2.0 * params_total
        hbm += 2.0 * 2 * B * S * d * L * 2     # residual stash write+read (bf16)
        hbm += 2.0 * B * S * d * L * 6         # layer activations traffic (est.)
    elif shape.kind == "prefill":
        hbm = p_bytes + 2.0 * B * S * d * L * 4
        if cfg.family != "ssm":
            kv_unit = (cfg.kv_lora_rank + cfg.qk_rope_dim) if cfg.mla \
                else 2 * cfg.num_kv_heads * cfg.head_dim
            hbm += 2.0 * B * S * kv_unit * L   # cache write
    else:
        hbm = p_bytes
        if cfg.family == "ssm":
            dh = 2 * cfg.d_model // cfg.num_heads
            hbm += 4.0 * B * cfg.num_heads * dh * dh * L
        elif cfg.family == "hybrid":
            hbm += 2.0 * B * (min(cfg.window, S) * 2 * cfg.num_kv_heads
                              * cfg.head_dim * (L - len(cfg.full_attn_every))
                              + S * 2 * cfg.num_kv_heads * cfg.head_dim
                              * len(cfg.full_attn_every))
            hbm += 4.0 * B * di * cfg.ssm_state * L
        elif cfg.mla:
            hbm += 2.0 * B * S * (cfg.kv_lora_rank + cfg.qk_rope_dim) * L
        else:
            hbm += 2.0 * B * S * 2 * cfg.num_kv_heads * cfg.head_dim * L
    return {"flops_global": flops, "hbm_bytes_global": hbm}


def chips_of(mesh: str) -> int:
    """The chips of a dry-run mesh: ``pod2x16x16`` 512, ``pod16x16`` 256."""
    return 512 if mesh == "pod2x16x16" else 256


def roofline_row(rec: dict) -> Optional[dict]:
    """One record's three terms, bottleneck and ratios; None unless the
    record is ``ok``."""
    if rec.get("status") != "ok":
        return None
    chips = chips_of(rec["mesh"])
    ana = analytic_cost(rec["arch"], rec["shape"], rec["params_total"],
                        rec["params_active"])
    t_compute = ana["flops_global"] / (chips * PEAK_FLOPS)
    t_memory = ana["hbm_bytes_global"] / (chips * HBM_BW)
    t_coll = rec["collective_bytes_per_device"] / LINK_BW
    terms = {"compute": t_compute, "memory": t_memory, "collective": t_coll}
    bottleneck = max(terms, key=terms.get)
    t_bound = terms[bottleneck]
    mfu_bound = t_compute / max(t_bound, 1e-30)
    useful = rec["model_flops_global"] / max(ana["flops_global"], 1.0)
    return {
        "arch": rec["arch"], "shape": rec["shape"], "mesh": rec["mesh"],
        "t_compute_s": t_compute, "t_memory_s": t_memory,
        "t_collective_s": t_coll, "bottleneck": bottleneck,
        "roofline_fraction": mfu_bound,
        "model_flops": rec["model_flops_global"],
        "executed_flops": ana["flops_global"],
        "useful_flops_ratio": useful,
        "hlo_flops_per_device_raw": rec["cost"]["flops_per_device"],
        "peak_gib_per_device": rec["memory"]["peak_bytes_per_device"] / 2**30,
        "peak_gib_tpu_estimate": rec["memory"].get(
            "peak_bytes_tpu_estimate", rec["memory"]["peak_bytes_per_device"]) / 2**30,
    }


def load_table(outdir="artifacts/dryrun", mesh="pod16x16"):
    """The rows of every ``ok`` record of ``mesh`` under ``outdir``, in file
    name order."""
    rows = []
    for p in sorted(Path(outdir).glob(f"*__{mesh}.json")):
        row = roofline_row(json.loads(p.read_text()))
        if row:
            rows.append(row)
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description="roofline of the dry-run records")
    ap.add_argument("--mesh", default="pod16x16")
    ap.add_argument("--out", default="artifacts/dryrun")
    args = ap.parse_args(argv)
    rows = load_table(args.out, args.mesh)
    print(f"{'arch':22s} {'shape':12s} {'t_comp':>9s} {'t_mem':>9s} "
          f"{'t_coll':>9s} {'bound':>10s} {'roofline%':>9s} {'useful%':>8s}")
    for r in rows:
        print(f"{r['arch']:22s} {r['shape']:12s} {r['t_compute_s']:9.2e} "
              f"{r['t_memory_s']:9.2e} {r['t_collective_s']:9.2e} "
              f"{r['bottleneck']:>10s} {100*r['roofline_fraction']:8.1f}% "
              f"{100*r['useful_flops_ratio']:7.1f}%")


if __name__ == "__main__":
    main()
