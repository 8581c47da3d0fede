#!/usr/bin/env python3
"""Where the bf16 attention backward's time goes at (128, 128): the kernel
built from this checkout's sources and from variants of them, timed in one
process on the card.

    python3 tools/attention_bwd_variants.py [VARIANT ...]

A variant is a set of text substitutions of ``src/repro_torch/kernels/
csrc/`` (``VARIANTS``), applied to a copy of it in a temporary directory
and built with the package's own ``nvcc`` flags (``kernels.build``). Each
is timed at internlm2-1.8b's training shape (``chip_smoke.py``'s
``ATTN_BWD_CASES``, "internlm2": (4, 16, 8, 1,128), bf16), at moonshot's
(4, 16, 16, 1,128), at granite-34b's MQA heads on one sequence (1, 48, 1,
1,128: per-head partials and the combine) and at deepseek-v3's MLA
(``MLA_BWD_CASES[0]``: (4, 128, 128, 1,000), query/key 192, value 128)
through ``kernels.flash_attention.
flash_attention_bwd`` on the plain version's o and lse: the launch's time
(``chip_smoke.median_ms``) and its kernels' device times
(``chip_smoke.kernel_split_ms``), in the order base, variants, base. Each
variant's gradients are compared with the base build's (max|variant -
base| / max|base|): a variant marked ``diagnostic`` drops work the
gradient needs, to show what that work costs, and is not expected to
agree. It needs one CUDA device and ``nvcc``.
"""
from __future__ import annotations

import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]

UNIT_ADJACENT = ("const int tile_slow =\n      nh > 1 ||",
                 "const int tile_slow = 0 &&")
PER_HEAD = ("constexpr long long kSumHeadsBlocks = 512;",
            "constexpr long long kSumHeadsBlocks = 1LL << 62;")
# the dK/dV kernel's first warpgroup with its next P^T made under the dV
# product (the next item's S^T issued first and waited for alone; P^T
# handed over once dV is done), and as it is (each item's dV and the next
# item's S^T issued together and waited for before the next P^T)
DKDV_PIPELINED = ("""  if (it >= 0) wg_product_t<NA>(x, af, kRole == 0 ? q_s : do_s);
  if (kRole == 0 && it >= 0) {
    p_from_st(x, lse_s, mk, (it & 0xFFFF) * kBQ, blk.k0, key0, quad_col, c2);
    put_p(p_s, 0, t, x);
  }
""", """    if constexpr (kRole == 0) {   // x holds item m's P^T, handed over
      if (it1 >= 0) bar_sync(kBarSlot + slot1, kThreadsWG2);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) acc_to_a<true>(x, kk, xh[kk], xl[kk]);
      wg_fence();
      issue_product_t<NA>(x, af, q_s + slot1 * NQ * kTileBytes);
      wg_commit();
      issue_accumulate_a<NO, true>(acc, xh, xl, do_s + slot * NV * kTileBytes);
      wg_commit();
      wg_wait<1>();
      wg_fence_acc(x);
      if (it1 >= 0)
        p_from_st(x, lse_s + slot1 * kBQ, mk, (it1 & 0xFFFF) * kBQ, blk.k0,
                  key0, quad_col, c2);
      wg_done<NO>(acc, x);
      if (it1 >= 0) put_p(p_s, m + 1, t, x);
    } else {""")
DKDV_SERIAL = ("""  if (it >= 0) wg_product_t<NA>(x, af, kRole == 0 ? q_s : do_s);
""", """    if constexpr (kRole == 0) {
      p_from_st(x, lse_s + slot * kBQ, mk, (it & 0xFFFF) * kBQ, blk.k0, key0,
                quad_col, c2);
      put_p(p_s, m, t, x);
      if (it1 >= 0) bar_sync(kBarSlot + slot1, kThreadsWG2);
      issue_accumulate<NO>(acc, x, xh, xl, do_s + slot * NV * kTileBytes);
      issue_product_t<NA>(x, af, q_s + slot1 * NQ * kTileBytes);
    } else {""")
# the dQ block's warpgroups split as dK/dV's (0: S and P; 1: dP, dS and
# dQ, each dQ product issued with the next dP), and as PR 25 split them
# (0: S, dP and dS; 1: dQ)
DQ_AS_DKDV = """  float l2[2], dl[2];
  blk.rows(lse, delta, row0, S, l2, dl);
  if constexpr (kRole == 0) {
    uint32_t qf[4 * NQ][4];
    ldsm_a_slabs<NQ>(qf, q_s, warp * 16, lane);
    const float c2 = scale * kLog2e;
    float x[8][4];   // S, then P
    for (int m = 0; m < tiles.n; ++m) {
      const int slot = m % kSlots;
      if (m > 0) bar_sync(kBarSlot + slot, kThreadsWG2);
      wg_product_t<NQ>(x, qf, k_s + slot * NQ * kTileBytes);
      p_from_s(x, l2, mk, blk.q0, tiles[m] * kBK, row0, quad_col, c2);
      put_p(p_s, m, t, x);
    }
  } else {
    uint32_t df[4 * NV][4];
    ldsm_a_slabs<NV>(df, do_s, warp * 16, lane);
    float acc[8 * NQ][4];   // dQ
#pragma unroll
    for (int j = 0; j < 8 * NQ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;
    float x[8][4];          // dP, then dS
    uint32_t xh[4][4], xl[4][4];
    // Each item's dQ product is issued together with the next item's dP,
    // as in dK/dV (the one after the last item reads a slot no one writes
    // then; its result is unused)
    wg_product_t<NV>(x, df, v_s);
    for (int m = 0; m < tiles.n; ++m) {
      if (m + 1 < tiles.n) slot_ready(m);
      const float4* p = get_p(p_s, m, t);
      if (m + 2 < tiles.n) {   // tile m - 1's slot: both are past it
        load_tile(One(), m + 2, (m + 2) % kSlots, t);
        cp_async_commit();
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float4 pj = p[j * kThreadsTC];
        x[j][0] = pj.x * (x[j][0] - dl[0]);
        x[j][1] = pj.y * (x[j][1] - dl[0]);
        x[j][2] = pj.z * (x[j][2] - dl[1]);
        x[j][3] = pj.w * (x[j][3] - dl[1]);
      }
      issue_accumulate<NQ>(acc, x, xh, xl, k_s + (m % kSlots) * NQ * kTileBytes);
      issue_product_t<NV>(x, df, v_s + (m + 1) % kSlots * NV * kTileBytes);
      wg_done<NQ>(acc, x);
    }
"""
DQ_BY_PRODUCT = """  if constexpr (kRole == 0) {
    uint32_t qf[4 * NQ][4], df[4 * NV][4];
    ldsm_a_slabs<NQ>(qf, q_s, warp * 16, lane);
    ldsm_a_slabs<NV>(df, do_s, warp * 16, lane);
    float l2[2], dl[2];
    blk.rows(lse, delta, row0, S, l2, dl);
    const float c2 = scale * kLog2e;
    float x[8][4], y[8][4];   // S, then P, then dS; dP
    for (int m = 0; m < tiles.n; ++m) {
      const int slot = m % kSlots;
      if (m > 0) bar_sync(kBarSlot + slot, kThreadsWG2);
      wg_fence();
      issue_product_t<NQ>(x, qf, k_s + slot * NQ * kTileBytes);
      issue_product_t<NV>(y, df, v_s + slot * NV * kTileBytes);
      wg_commit();
      wg_wait_all();
      wg_fence_acc(x);
      wg_fence_acc(y);
      p_from_s(x, l2, mk, blk.q0, tiles[m] * kBK, row0, quad_col, c2);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) x[j][e] *= y[j][e] - dl[e >> 1];
      put_p(p_s, m, t, x);
    }
  } else {
    float acc[8 * NQ][4];   // dQ
#pragma unroll
    for (int j = 0; j < 8 * NQ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;
    float x[8][4];          // dS
    uint32_t xh[4][4], xl[4][4];
    for (int m = 0; m < tiles.n; ++m) {
      if (m + 1 < tiles.n) slot_ready(m);
      const float4* p = get_p(p_s, m, t);
      if (m + 2 < tiles.n) {   // tile m - 1's slot: both are past it
        load_tile(One(), m + 2, (m + 2) % kSlots, t);
        cp_async_commit();
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float4 pj = p[j * kThreadsTC];
        x[j][0] = pj.x, x[j][1] = pj.y, x[j][2] = pj.z, x[j][3] = pj.w;
      }
      issue_accumulate<NQ>(acc, x, xh, xl, k_s + (m % kSlots) * NQ * kTileBytes);
      wg_done<NQ>(acc, x);
    }
"""
# the bf16 Delta kernel templated on Dv (a lane's loads issued before
# its sums), and as PR 19 wrote it (Dv a launch argument, a load pair a
# loop iteration)
DELTA_UNROLLED = ("""// bf16: 8 lanes a row, 8 values (16 bytes) a load, a lane's loads all
// issued before its sums
template <int DV>
__global__ void __launch_bounds__(256)
delta_kernel_bf16(const bf16* __restrict__ o, const bf16* __restrict__ dO,
                  float* __restrict__ delta, long long rows) {
  constexpr int kChunks = DV / 8, kPer = (kChunks + 7) / 8;
  const long long row = blockIdx.x * 32LL + (threadIdx.x >> 3);
  const int l8 = threadIdx.x & 7;
  float acc = 0.0f;
  if (row < rows) {
    uint4 ov[kPer], dv[kPer];
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int c = l8 + 8 * i;
      if (c >= kChunks) continue;
      ov[i] = *reinterpret_cast<const uint4*>(o + row * DV + 8 * c);
      dv[i] = *reinterpret_cast<const uint4*>(dO + row * DV + 8 * c);
    }
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      if (l8 + 8 * i >= kChunks) continue;
      const bf16* op = reinterpret_cast<const bf16*>(&ov[i]);
      const bf16* dp = reinterpret_cast<const bf16*>(&dv[i]);
#pragma unroll
      for (int e = 0; e < 8; ++e)
        acc = fmaf(__bfloat162float(dp[e]), __bfloat162float(op[e]), acc);
    }
  }
""", """    delta_kernel_bf16<DV><<<static_cast<unsigned>((rows + 31) / 32), 256, 0,
                            stream>>>(ob, db, delta, rows);""")
DELTA_LOOP = ("""// bf16: 8 lanes a row, 8 values (16 bytes) a load
__global__ void __launch_bounds__(256)
delta_kernel_bf16(const bf16* __restrict__ o, const bf16* __restrict__ dO,
                  float* __restrict__ delta, long long rows, int Dv) {
  const long long row = blockIdx.x * 32LL + (threadIdx.x >> 3);
  const int l8 = threadIdx.x & 7;
  float acc = 0.0f;
  if (row < rows) {
    for (int c = l8; c < Dv / 8; c += 8) {
      const uint4 ov = *reinterpret_cast<const uint4*>(o + row * Dv + 8 * c);
      const uint4 dv = *reinterpret_cast<const uint4*>(dO + row * Dv + 8 * c);
      const bf16* op = reinterpret_cast<const bf16*>(&ov);
      const bf16* dp = reinterpret_cast<const bf16*>(&dv);
#pragma unroll
      for (int e = 0; e < 8; ++e)
        acc = fmaf(__bfloat162float(dp[e]), __bfloat162float(op[e]), acc);
    }
  }
""", """    delta_kernel_bf16<<<static_cast<unsigned>((rows + 31) / 32), 256, 0,
                        stream>>>(ob, db, delta, rows, DV);""")
# name: (diagnostic, {file of csrc/: [(old, new), ...]}[, the cases it is
# timed at, where not all])
VARIANTS = {
    # the dK/dV grid with a unit's key tiles adjacent at every shape, in
    # place of the key tile as the slow axis where a block sums G > 1
    # heads or every head's Q and dO fit in L2
    "unit_adjacent": (False, {"flash_attention_bwd.cu": [UNIT_ADJACENT]}),
    # a dK/dV block a query head at every shape (fp32 partials and the dQ
    # launch's combine blocks where H != K), in place of the kv head's G
    # query heads in one block where the launch has enough blocks
    "per_head": (False, {"flash_attention_bwd.cu": [PER_HEAD]}),
    "per_head_unit_adjacent": (False, {"flash_attention_bwd.cu": [
        PER_HEAD, UNIT_ADJACENT]}),
    "dkdv_pipelined": (False, {"flash_attention_bwd.cu": list(
        zip(DKDV_SERIAL, DKDV_PIPELINED))}),
    "dq_as_dkdv": (False, {"flash_attention_bwd.cu": [
        (DQ_BY_PRODUCT, DQ_AS_DKDV)]}),
    # the dQ grid with the q tile as its slow axis (every head's last q
    # tile first), in place of a head's q tiles adjacent (where the grid
    # has no combine block: every block a dQ one)
    "q_tile_slow": (False, {"flash_attention_bwd.cu": [(
        "const QBlock blk(H, K, blockIdx.x % n_qt, n_qt, blockIdx.x / n_qt);",
        "const QBlock blk(H, K, blockIdx.x / (gridDim.x / n_qt), n_qt, "
        "blockIdx.x % (gridDim.x / n_qt));")]},
        ("internlm2", "moonshot", "mla")),
    # the second products over two 64-column slabs (dV, dK and dQ at (128,
    # 128)) as two m64n64k16 products a k-step, in place of one m64n128k16
    "n64_pieces": (False, {"wgmma.cuh": [(
        "if constexpr (NS == 2) {   // one m64n128k16 product over both slabs",
        "if constexpr (NS < 0) {")]}),
    "delta_loop": (False, {"flash_attention_bwd.cu": list(
        zip(DELTA_UNROLLED, DELTA_LOOP))}),
    # the second products without their bf16 lo halves (P^T, dS^T and dS
    # as bf16 alone): what the hi + lo split costs
    "no_lo": (True, {"wgmma.cuh": [
        ("      wgmma_rs128<1>(acc, xl[kk], b, 1);\n", ""),
        ("        wgmma_rs<1>(piece(acc, s), xl[kk], b, 1);\n", "")]}),
    # p = 2^x taken as x (no exponential on the SFU): what the
    # exponentials cost
    "no_exp": (True, {"flash_attention_bwd.cu": [(
        "st[j][h] = ex2(fmaf(", "st[j][h] = (fmaf("), (
        "st[j][h + 2] = ex2(fmaf(", "st[j][h + 2] = (fmaf("), (
        "s[j][e] = ex2(fmaf(", "s[j][e] = (fmaf(")]}),
    # no item's Q, dO (dK/dV) or K, V (dQ) loaded past the first two (the
    # ring's third slot holds what shared memory held): what streaming the
    # items costs
    "no_stream": (True, {"flash_attention_bwd.cu": [
        ("load_item(One(), it2, (m + 2) % kSlots, t);", ""),
        ("load_tile(One(), m + 2, (m + 2) % kSlots, t);", "")]}),
}


def variant_csrc(name: str, root: Path) -> Path:
    """A copy of the kernels' sources under ``root`` with ``name``'s
    substitutions made; each must match exactly once."""
    src = HERE / "src/repro_torch/kernels/csrc"
    dst = root / name / "csrc"
    shutil.copytree(src, dst)
    for fname, subs in VARIANTS[name][1].items():
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
            only = VARIANTS[name][2] if len(VARIANTS.get(name, ())) > 2 \
                else tuple(inputs)
            for label, args in inputs.items():
                if label not in only:
                    continue
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
        tag = " (diagnostic)" if name in VARIANTS and VARIANTS[name][0] \
            else ""
        for label in inputs:
            if label not in row:
                continue
            r = row[label]
            print(f"{name}{tag} {label} {cases[label]}: "
                  f"{r['ms']:.4f} ms; on the device: " + ", ".join(
                      f"{n} {cs.fmt_ms(t)}" for n, t in
                      r["stages_ms"].items())
                  + f"; gradients {r['gap_to_base']:.3e} of max|base| from "
                  f"the base build's", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
