#!/usr/bin/env python3
"""Where the bf16 attention backward's time goes on the two-warpgroup pair
at (128, 128), (192, 128) and (96, 96): the kernel built from this
checkout's sources and from variants of them that each drop one part of
the work the gradient needs, timed in one process on the card.

    python3 tools/attention_bwd_variants.py [VARIANT ...]

A variant is a set of text substitutions of ``src/repro_torch/kernels/
csrc/`` (``VARIANTS``), applied to a copy of it in a temporary directory
and built with the package's own ``nvcc`` flags (``kernels.build``). Each
is timed at internlm2-1.8b's training shape (``chip_smoke.py``'s
``ATTN_BWD_CASES``, "internlm2": (4, 16, 8, 1,128), bf16), at moonshot's
(4, 16, 16, 1,128), at granite-34b's MQA heads on one sequence (1, 48, 1,
1,128: per-head partials and the combine), at deepseek-v3's MLA
(``MLA_BWD_CASES[0]``: (4, 128, 128, 1,000), query/key 192, value 128)
and at phi-3-vision-4.2b's (4, 32, 32, 1,128, 96) (``ATTN_BWD_CASES``,
"phi") through ``kernels.flash_attention.flash_attention_bwd`` on the
plain version's o and lse: the launch's time (``chip_smoke.median_ms``)
and its kernels' device times (``chip_smoke.kernel_split_ms``), in the
order base, variants, base. Each variant's gradients are compared with
the base build's (max|variant - base| / max|base|); since a variant drops
work, they are not expected to agree. It needs one CUDA device and
``nvcc``.
"""
from __future__ import annotations

import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]

# name: {file of csrc/: [(old, new), ...]}
VARIANTS = {
    # the second products without their bf16 lo halves (P^T, dS^T and dS
    # as bf16 alone): what the hi + lo split costs
    "no_lo": {"wgmma.cuh": [
        ("      wgmma_rs128<1>(acc, xl[kk], b, 1);\n", ""),
        ("      wgmma_rs96<1>(acc, xl[kk], b, 1);\n", ""),
        ("        wgmma_rs<1>(piece(acc, s), xl[kk], b, 1);\n", "")]},
    # p = 2^x taken as x (no exponential on the SFU): what the
    # exponentials cost
    "no_exp": {"flash_attention_bwd.cu": [(
        "st[j][h] = ex2(fmaf(", "st[j][h] = (fmaf("), (
        "st[j][h + 2] = ex2(fmaf(", "st[j][h + 2] = (fmaf("), (
        "s[j][e] = ex2(fmaf(", "s[j][e] = (fmaf(")]},
    # no item's Q, dO (dK/dV) or K, V (dQ) loaded past the first two (the
    # ring's third slot holds what shared memory held): what streaming the
    # items costs
    "no_stream": {"flash_attention_bwd.cu": [
        ("load_item(One(), it2, (m + 2) % kSlots, t);", ""),
        ("load_tile(One(), m + 2, (m + 2) % kSlots, t);", "")]},
}


def variant_csrc(name: str, root: Path) -> Path:
    """A copy of the kernels' sources under ``root`` with ``name``'s
    substitutions made; each must match exactly once."""
    src = HERE / "src/repro_torch/kernels/csrc"
    dst = root / name / "csrc"
    shutil.copytree(src, dst)
    for fname, subs in VARIANTS[name].items():
        path = dst / fname
        text = path.read_text()
        for old, new in subs:
            if text.count(old) != 1:
                raise SystemExit(f"variant {name}: {old!r} matches "
                                 f"{text.count(old)} times in {fname}")
            text = text.replace(old, new)
        path.write_text(text)
    return dst


def main() -> int:
    names = sys.argv[1:] or list(VARIANTS)
    unknown = [n for n in names if n not in VARIANTS]
    if unknown:
        raise SystemExit(f"unknown variants {unknown}; known: "
                         f"{list(VARIANTS)}")
    sys.path.insert(0, str(HERE))
    import chip_smoke as cs                 # puts HERE/src on sys.path
    import numpy as np
    import torch
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as kflash
    from repro_torch.kernels import ref
    sys.path.insert(0, str(HERE / "tools"))
    from attention_builds import plain_lse
    dev = torch.device("cuda")
    cases = {label: case[:5] for label, case in zip(cs.ATTN_BWD_TIMED,
                                                    cs.ATTN_BWD_CASES)
             if label in ("internlm2", "moonshot")}
    cases["granite"] = next(c[:5] for c in cs.ATTN_BWD_CASES
                            if c[:3] == (1, 48, 1))
    cases["mla"] = cs.MLA_BWD_CASES[0][:6]
    cases["phi"] = next(c[:5] for label, c in zip(cs.ATTN_BWD_TIMED,
                                                  cs.ATTN_BWD_CASES)
                        if label == "phi")
    inputs = {}
    for label, shape in cases.items():
        q, k, v = cs.attn_inputs(shape, torch.bfloat16, 0, dev)
        do = torch.from_numpy(np.random.default_rng(1).normal(
            size=q.shape[:3] + v.shape[3:]).astype(np.float32)).to(
                dev, torch.bfloat16)
        o = ref.attention_ref(q, k, v, round_p=False)
        inputs[label] = (q, k, v, o, do, plain_lse(q, k))
        torch.cuda.empty_cache()
    base_csrc = build.CSRC
    results, base_grads = [], {}
    with tempfile.TemporaryDirectory() as tmp:
        for name in ["base", *names, "base"]:
            build.CSRC = (base_csrc if name == "base"
                          else variant_csrc(name, Path(tmp)))
            build.load.cache_clear()
            row = {"variant": name}
            for label, args in inputs.items():
                def bwd(args=args):
                    return kflash.flash_attention_bwd(*args)
                grads = bwd()
                torch.cuda.synchronize()
                if name == "base" and label not in base_grads:
                    base_grads[label] = grads
                gaps = [((g.float() - b.float()).abs().max()
                         / b.float().abs().max()).item()
                        for g, b in zip(grads, base_grads[label])]
                row[label] = {"ms": cs.median_ms(bwd),
                              "stages_ms": cs.kernel_split_ms(
                                  bwd, cs.ATTN_BWD_KERNELS),
                              "gap_to_base": max(gaps)}
            results.append(row)
            build.CSRC = base_csrc
            build.load.cache_clear()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    for row in results:
        name = row["variant"]
        for label in inputs:
            r = row[label]
            print(f"{name} {label} {cases[label]}: "
                  f"{r['ms']:.4f} ms; on the device: " + ", ".join(
                      f"{n} {cs.fmt_ms(t)}" for n, t in
                      r["stages_ms"].items())
                  + f"; gradients {r['gap_to_base']:.3e} of max|base| from "
                  f"the base build's", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
