#!/usr/bin/env python3
"""The bf16 attention forward on wgmma at D = 96 and 64: the kernel built
from this checkout's sources and from variants of them, timed in one
process on the card.

    python3 tools/attention_fwd_variants.py [VARIANT ...]

A variant is a set of text substitutions of ``src/repro_torch/kernels/
csrc/`` (``VARIANTS``), applied to a copy of it in a temporary directory
and built with the package's own ``nvcc`` flags (``kernels.build``). Each
build runs ``kernels.flash_attention.flash_attention`` at phi-3-vision-
4.2b's prefill (4, 32, 32, 1,000, 96), musicgen-medium's (4, 24, 24,
1,000, 64) (``chip_smoke.py``'s ``FAMILY_ATTN_SHAPES``) and hymba-1.5b's
(4, 25, 5, 1,128, 64, window 1,024, sink 128), with p in float32 (the
models' call) and rounded, in the order base, variants, base: the
launch's time (``chip_smoke.median_ms``), its output against the plain
version at phase 8's gates and against the base build's, and the
``flash_kernel_wg`` instantiations' registers and spills from the
build's ``-Xptxas -v`` report. SDPA's time at each shape (causal, p
rounded: like for like) and the bound are printed once. It needs one CUDA
device and ``nvcc``.
"""
from __future__ import annotations

import re
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]

# name: {file of csrc/: [(old, new), ...]}
VARIANTS = {
    # three consumer warpgroups a block (192-row q tiles, a ring of 3
    # slots, 152 registers a consumer) at D = 64 and 96
    "three_consumers": {"flash_attention.cu": [(
        "constexpr int wg_consumers() {\n  return 2;",
        "constexpr int wg_consumers() {\n  return D <= 96 ? 3 : 2;")]},
    # the same at D = 64 alone
    "three_consumers_64": {"flash_attention.cu": [(
        "constexpr int wg_consumers() {\n  return 2;",
        "constexpr int wg_consumers() {\n  return D == 64 ? 3 : 2;")]},
}

# (label, (B, H, K, S, D), window, sink)
CASES = (("phi-3-vision", (4, 32, 32, 1000, 96), None, 0),
         ("musicgen", (4, 24, 24, 1000, 64), None, 0),
         ("hymba", (4, 25, 5, 1128, 64), 1024, 128))


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


def wg_report(build) -> dict:
    """{"<D, Dv> p float32|p rounded": ptxas report} of the flash_kernel_wg
    instantiations of the library ``build`` builds now."""
    sys.path.insert(0, str(HERE))
    import chip_smoke as cs
    log = build.build_library("flash_attention").with_suffix(
        ".log").read_text()
    out = {}
    for name, rep in cs.ptxas_kernels(log).items():
        m = re.search(r"flash_kernel_wgILi(\d+)ELi(\d+)ELb([01])E", name)
        if m:
            p = "p float32" if m[3] == "1" else "p rounded"
            out[f"<{m[1]}, {m[2]}> {p}"] = rep
    return out


def main() -> int:
    names = sys.argv[1:] or list(VARIANTS)
    unknown = [n for n in names if n not in VARIANTS]
    if unknown:
        raise SystemExit(f"unknown variants {unknown}; known: "
                         f"{list(VARIANTS)}")
    sys.path.insert(0, str(HERE))
    import chip_smoke as cs                 # puts HERE/src on sys.path
    import torch
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as kflash
    from repro_torch.kernels import ref
    dev = torch.device("cuda")
    inputs, wants = {}, {}
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for label, shape, window, sink in CASES:
        q, k, v = cs.attn_inputs(shape, torch.bfloat16, 0, dev)
        inputs[label] = (q, k, v, window, sink)
        for round_p in (False, True):
            wants[label, round_p] = ref.attention_ref(
                q, k, v, window=window, sink=sink, round_p=round_p)
        B, H, K, S, D = shape
        b_ms, b_by = cs.attn_bound(B, H, K, S, D, 2, window, sink)
        # (hymba's window and sink leave the causal mask at S = 1,128)
        lib_ms = cs.median_ms(lambda: sdpa(q, k, v, is_causal=True,
                                           enable_gqa=True))
        print(f"{label} {shape} window={window} sink={sink}: bound "
              f"{b_ms:.4f} ms ({b_by}), SDPA (causal, p rounded) "
              f"{lib_ms:.4f} ms", flush=True)
    base_csrc = build.CSRC
    results, base_outs = [], {}
    with tempfile.TemporaryDirectory() as tmp:
        for name in ["base", *names, "base"]:
            build.CSRC = (base_csrc if name == "base"
                          else variant_csrc(name, Path(tmp)))
            build.load.cache_clear()
            row = {"variant": name, "ptxas": wg_report(build)}
            for label, (q, k, v, window, sink) in inputs.items():
                for round_p in (False, True):
                    def fwd(q=q, k=k, v=v, window=window, sink=sink,
                            round_p=round_p):
                        return kflash.flash_attention(
                            q, k, v, window=window, sink=sink,
                            round_p=round_p)
                    n0 = kflash.flash_attention.wg_launches
                    got = fwd()
                    torch.cuda.synchronize()
                    wg = kflash.flash_attention.wg_launches - n0
                    want = wants[label, round_p]
                    if round_p:
                        err = (got.float() - want.float()).abs().max().item()
                        ok = err <= cs.TOL_ATTN["bfloat16"]
                        gap = f"max abs {err:.3e} from the plain version"
                    else:
                        ulps, share = ref.bf16_ulp_gaps(got, want)
                        ok = (ulps <= cs.MAX_ULPS_P_F32
                              and share <= cs.MAX_SHARE_P_F32)
                        gap = (f"{ulps:.3g} ulp, {100 * share:.4f} % of "
                               f"elements from the plain version")
                    key = (label, round_p)
                    if name == "base" and key not in base_outs:
                        base_outs[key] = got
                    same = torch.equal(got, base_outs[key])
                    row[key] = {
                        "ms": cs.median_ms(fwd), "ok": ok, "gap": gap,
                        "same_as_base": same, "wg": wg}
            results.append(row)
            build.CSRC = base_csrc
            build.load.cache_clear()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    failed = False
    for row in results:
        name = row["variant"]
        print(f"{name}: flash_kernel_wg " + "; ".join(
            f"{k} {r.get('registers')} registers, {r.get('spill_stores')} B "
            f"of spill stores" for k, r in sorted(row["ptxas"].items())),
            flush=True)
        for (label, round_p), r in ((k, v) for k, v in row.items()
                                    if isinstance(k, tuple)):
            print(f"{name} {label} round_p={round_p}: {r['ms']:.4f} ms, "
                  f"{r['wg']} flash_kernel_wg launch, {r['gap']} (within "
                  f"phase 8's gates: {r['ok']}), bit-equal to the base "
                  f"build's {r['same_as_base']}", flush=True)
            failed |= not r["ok"]
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
