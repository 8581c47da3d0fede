#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0]

Run from the root of a checkout; it needs one CUDA device and ``nvcc``.
Phases, each of which fails the run (non-zero exit) if its check fails:

1. device   name, count, and ``nvidia-smi`` name and power limit;
2. build    every kernel from ``kernels/csrc/*.cu`` (retention, ssm_scan,
            ssm_scan_bwd, flash_attention, flash_attention_bwd), one
            ``nvcc`` each, all started together, and print each ``-Xptxas
            -v`` report (registers, spills);
3. kernel   against its plain PyTorch version on the card at B = 14 (the
            packed nominal rows: 7 bitcells x level shifter), 127 and 129
            (either side of the 128-row block), 130 (ragged) and 2^20 (rows
            perturbed from ``--seed``), rtol 1e-5; rows that start crossed
            must agree exactly;
4. main     ``explore(device="cuda")`` on the paper grid: Table 2 at 7/7,
            through the kernel (launch count > 0), metric columns equal to
            the CPU build of the same table within ``RTOL_CPU``;
5. wide     ``DesignTable.build`` of the 2,808-config grid on the card:
            every value finite;
6. timing   kernel and plain version with CUDA events at B = 120 (the main
            path's shape) and 2^20, beside the kernel's bound;
7. profile  one warm ``explore`` under ``torch.profiler``: device busy time
            and share, and the kernels that take it;
8. kernels  flash attention and the selective scan against their plain
            versions on the card: the reference's shapes, ragged S, GQA,
            a di no block divides, and hymba-1.5b's full-width prefill
            shapes; attention also with window and sink
            (``ATTN_MASK_CASES``) and both treatments of p, float32 and
            bf16 (tolerances ``TOL_ATTN``, ``MAX_ULPS_P_F32`` and
            ``MAX_SHARE_P_F32``, ``TOL_SSM``);
9. serve    hymba-1.5b at full width (32 layers, d_model 1600, bf16,
            weights from a ``torch.Generator`` seeded with ``--seed``):
            ``Engine.generate`` of 4 requests x 1,000-token prompts, 32
            greedy decode steps, max_seq 1,040 (the SWA ring wraps). Both
            kernels launch once a layer (32 attention: 3 global and 29
            sliding-window layers, as many on ``flash_kernel_wg`` as
            ``kflash.forward_kernel`` routes there: all 32 since D = 64
            runs on wgmma; 32 scan launches a call), every
            logit is finite, two calls give identical tokens; prefill
            seconds and decode tokens/s, first call and warm; decode-vs-
            prefill logit agreement at this width with the depth cut to
            1-32 layers, float32 and bf16, gated in float32 at <= 2 layers
            (``RTOL_DECODE_PREFILL``), printed otherwise;
10. parity  the reduced hymba (float32) on the card and on the CPU with the
            same weights, carried to the card by ``convert``: identical
            greedy tokens, logits within ``RTOL_SERVE_CPU``;
11. timing  each serve kernel, its plain version and (attention)
            ``scaled_dot_product_attention`` with CUDA events at the full-
            width shapes, beside the kernel's bound: attention with p
            rounded and in float32 (the model's), causal and with hymba's
            window and sink;
12. profile one prefill and one warm decode step under ``torch.profiler``,
            and the attention and scan kernels' shares of the prefill;
13. corners the retention kernel at hot, cold, low_vdd and the cold-boost
            point (1.2 V, 233 K), at each corner's thermal voltage, against
            its plain version at the same ``ut`` (rtol 1e-5, start-crossed
            rows exact) on the paper grid's rows packed at the corner and
            on rows perturbed from the 14 nominal ones (B = 127, 129,
            2^20); its time at B = 120 and 2^20 beside nominal's; at hot
            every gain-cell row of the paper grid retains for less time
            than at nominal;
14. table   ``explore(corners=<the four named corners>,
            robust="worst_case", device="cuda")`` on the paper grid (120)
            and the wide grid (2,808): 4 retention launches a build,
            every column within ``RTOL_CPU`` of the CPU build, labels and
            picks equal to the CPU's; wall time first call and warm;
15. compose ``hetero.compose(device="cuda")`` against the goldens, read as
            JSON: Table 2 through compose (7/7), the 3-level reference
            task under ``preference`` and ``power_bb``
            (``tests/golden/table2_nlevel.json``), and the vdd sweep to
            (1.2 V, 233 K) (``tests/golden/table2_vdd.json``: flips of tasks
            1, 2, 4 and 6), discrete fields exact and metrics within
            ``RTOL_GOLDEN``; one retention launch a swept compose;
            branch-and-bound ``n_scored``, scoring dispatches, wall time
            first and warm, and one warm swept compose under
            ``torch.profiler``;
16. simulate ``api.simulate(device="cuda")`` (``compose(refine=
            "simulate")``) on the paper grid for the 7 Table-2 tasks with
            the default ``SimPolicy``: 7/7, ``refined == "simulate"``,
            compositions and re-rank order equal to a ``device="cpu"`` run,
            ``sim_*`` metrics within ``RTOL_SIM``; the 3-level task under
            ``ComposePolicy(objective="power")`` and
            ``SimPolicy(objective="energy")``, order equal to the CPU's; the
            cold-boost replay ((1.2 V, 233 K) block, adaptive refresh, 30 K
            drift): less refresh energy at the cold block, card within
            ``RTOL_SIM`` of the CPU; ``simulate_traces`` at J = 65,536
            compositions (from ``--seed``, sentinels included) x 4 slots x 3
            phases, card within ``RTOL_SIM`` of the CPU; a cached repeat
            runs no replay and no retention launch; wall time first and
            warm, retention launches a call, and one warm simulate under
            ``torch.profiler``;
17. facade ``Compiler().compile(gc_ossi 64x128)``: one retention launch, PPA
            within ``RTOL_CPU`` of the CPU's; ``Macro.write_all``: ``.sp``
            and ``.lef`` byte-equal to the CPU's, ``.v`` and ``.lib``
            byte-equal given the CPU's PPA, DRC and LVS clean;
            ``Compiler().gradient_size`` within ``RTOL_GRAD`` of the CPU's;
            its wall time on the card and the CPU, and one warm sizing on
            the card under ``torch.profiler``;
18. obs    telemetry: ``Compiler(device="cuda", telemetry=True)``'s
            ``explore``, ``compose`` swept to (1.2 V, 233 K), ``compose``
            under ``power_bb`` on ``nlevel_task(3)`` and ``simulate``, and a
            full-width hymba ``generate`` (8 steps) under
            ``obs.enabled_scope(True)``: the Chrome trace written and its
            report printed, every emitted name covered by the catalog,
            ``kernels.dispatch.retention.cuda`` equal to each path's
            retention launches, the serve kernels' dispatches equal to their
            launches, outputs bit-equal with telemetry off, warm wall time
            off and on, and a warm ``explore`` profiled off and on with the
            same launch and copy calls from the host; the sanitizer: ``Compiler(sanitize=True)``'s
            ``explore``, swept ``compose`` and ``simulate`` clean and
            bit-equal, their warm cost, a made NaN and an out-of-range
            gather raising on ``cuda:0`` (the gather before it launches:
            the card goes on after it); the grid: ``score_grid`` and
            ``score_grid_corners`` at J = 65,536 x 4 slots (x the 4 named
            corners) over ``[cuda:0] x 2`` and ``x 4`` bit-equal to the
            plain call, and ``compose(sharded=True)`` on the one card equal
            to ``compose()``;
19. bwd    the two backward kernels, through their autograd wrappers (one
            launch a backward), against autograd of their plain versions
            (``ref.attention_ref_grads``, ``ref.ssm_scan_ref_grads``):
            attention at hymba-1.5b's training shapes (4, 25, 5, 1,128, 64)
            in bf16 with window 1,024 and sink 128 and without a window,
            internlm2-1.8b's (4, 16, 8, 1,128, 128) and moonshot's (4, 16,
            16, 1,128, 128) in bf16, and granite-34b's MQA heads (1, 48, 1,
            1,128, 128) (the dense family's (128, 128) backward,
            ``dkdv_kernel_wg2`` / ``dq_kernel_wg2``), phi-3-vision-4.2b's
            (4, 32, 32, 1,128, 96) in bf16, GQA at D = 96 under
            ``kflash.SUM_HEADS_BLOCKS`` dK/dV blocks (1, 8, 2, 1,128: per-
            head partials and the combine) and D = 96 with a window and a
            sink (the two-warpgroup pair at (96, 96), on three 32-column
            slabs a row; the wg2 kernels' registers, spills and ptxas's
            wgmma notes printed at (128, 128) and (96, 96); the phase fails
            unless they run on wgmma with no spill stores; each timed case
            prints how many query heads a dK/dV block sums and whether the
            launch wrote fp32 partials and combined them), and
            small shapes in bf16 and float32; the scan at (4, 1,128, 3,200,
            16) and small shapes, float32; max|kernel - plain| / max|plain|
            per gradient against ``RTOL_ATTN_BWD`` / ``RTOL_SSM_BWD``; at
            the training shapes each backward run twice, bit-equal; each
            kernel's time there (the median of ``TIME_REPEATS`` queued event
            timings, as for SDPA's, and beside it one un-queued reading)
            beside its bound, the plain backward's time and (attention)
            SDPA's backward's, pinned to one backend (``SDPA_BACKENDS``: the
            first that runs, named); each launch's kernels' device times
            from one ``torch.profiler`` window over ``SPLIT_CALLS`` whole
            launches (attention: delta, dK/dV, dQ with the dK/dV combine;
            the scan: chunk adjoints, carries, gradients, reduction), the
            window run again, up to ``SPLIT_WINDOWS`` in all, while its
            trace lacks one of them, and a kernel none recorded is written
            down as not measured; the attention backward at MLA's head dims
            (``MLA_BWD_CASES``: deepseek-v3's (4, 128, 128, 1,000) with
            query/key 192 and value 128, a ragged S, and the reduced 24 /
            16 padded to 32; float32 and bf16) against
            ``ref.attention_ref_grads`` with the same gates (the bf16
            (192, 128) cases' forward on ``flash_kernel_wg``, once a case),
            bit-equal twice at the training shape, and its bf16 time beside
            its bound (6 Dqk + 4 Dv flops a visible score), the plain
            backward's and SDPA's where a backend takes Dv != D; there also
            its three kernels' device times, each beside its own bound
            (``attn_bwd_stage_bounds``), and its dK/dV and dQ kernels'
            route, registers and spills from the build's ``-Xptxas -v``
            report: the phase fails unless they run on wgmma with no spill
            stores;
20. train  hymba-1.5b at full width in bf16 (1,655,198,400 parameters from
            ``--seed``): ``make_train_step(remat="full")`` with AdamW, lr
            1e-3, warmup 2, on ``SyntheticLMData(cfg, 4, 1128, seed)``
            (1,000 text + 128 meta tokens), 8 steps: every loss and
            grad_norm finite; per step 64 launches of each forward kernel
            (the layer recomputed in the backward), 32 of each backward
            kernel, and no plain dispatch; first and warm step seconds,
            tokens/s, peak memory, model FLOPs against the bf16 dense peak;
            one warm step under ``torch.profiler`` (device busy share, top
            kernels, idle gaps, the four kernels' shares);
21. parity the reduced hymba (float32) on the card against the CPU with the
            same weights: the loss and every gradient leaf within
            ``RTOL_TRAIN_CPU``; a ``Supervisor`` run of 6 steps (checkpoints
            every 2) with a failure injected at step 4, restored from its
            checkpoint: parameters bit-equal to an uninjected run, the same
            losses and the data stream at the same state;
22. moe-attn the flash-attention kernel against its plain version at the
            MoE and dense families' shapes (``MOE_ATTN_SHAPES``): moonshot-
            v1-16b-a3b's prefill (4, 16, 16, 1,000, 128), granite-34b's MQA
            (1, 48, 1, 512, 128), deepseek-v3's MLA with query/key 192 and
            value 128 at (4, 128, 128, 1,000) and on a ragged S, and the
            reduced MLA's 24 / 16 (q and k padded to 32), float32 and bf16,
            both treatments of p, phase 8's gates; at the full-width shapes
            the kernel's time (``median_ms``) with p in float32 (the
            model's call) and with p rounded (SDPA's, like for like), bound
            (2 Dqk + 2 Dv flops a visible score), the plain version's and
            SDPA's where SDPA takes the call; the bf16 kernel at (128, 128)
            and (192, 128) is ``flash_kernel_wg`` (wgmma; one wgmma launch
            counted a call there, none elsewhere): the registers and spills
            of its 8 instantiations (``kflash.WGMMA_FWD_PAIRS``, both
            treatments of p) from the build's ``-Xptxas -v`` report, and
            the phase fails on a spill store;
23. moonshot moonshot-v1-16b-a3b at full width and depth (48 layers: 1
            dense, 47 MoE of 64 experts top-6 + 1 shared; 27.98 B bf16
            parameters from ``--seed``, each stacked leaf filled a layer at
            a time), served as phase 9 twice: 48 flash-attention launches a
            generate (one a prefill layer, on ``flash_kernel_wg``) and no
            plain dispatch, tokens in the vocabulary, logits finite, the two
            calls' tokens identical;
            init seconds and peak memory, prefill seconds, decode tokens/s,
            peak memory of a generate, and the least time of a decode
            step's expert stream (every expert's weights read once); the
            model is freed after;
24. deepseek deepseek-v3-671b at full width cut to 4 layers (3 dense, 1 MoE
            of 256 experts top-8 + 1 shared; MLA; the MTP module in the
            tree: 26.72 B parameters), served the same way: 4 launches a
            generate (MLA at (192, 128)), and the absorbed decode's latent
            cache written row by row;
25. parity the reduced moonshot and deepseek (float32) on the card and the
            CPU with the same weights, as phase 10: identical greedy tokens,
            the prefill's and every decode step's logits within
            ``RTOL_SERVE_CPU``; and their loss and every gradient leaf as
            phase 21 (``RTOL_TRAIN_CPU``; deepseek: MLA, MoE and MTP), one
            attention backward launch a layer (MTP's layer too) and no
            plain dispatch on the card;
26. vis-attn the flash-attention kernel against its plain version at
            phi-3-vision-4.2b's prefill (4, 32, 32, 1,000, 96) and
            musicgen-medium's (4, 24, 24, 1,000, 64), as phase 22: float32
            and bf16, both treatments of p, phase 8's gates, one
            ``flash_kernel_wg`` launch a bf16 call (D = 96 on three
            32-column slabs, D = 64 on one); each one's time (p in float32
            and rounded), bound, the plain version's and SDPA's, and the
            wgmma kernel's registers and spills, failing on a spill store;
27. vision phi-3-vision-4.2b, nothing cut (32 layers, d_model 3,072, 32
            heads of 96; 3,833,662,464 bf16 parameters from ``--seed``),
            served as phase 23 on 4 prompts of 576 patches of 1,024 (unit
            normal) + 424 text tokens: 32 attention launches a generate
            (32 on ``flash_kernel_wg``), no plain dispatch, no other
            kernel; the decode step's least
            time is every bf16 weight read once;
28. audio  musicgen-medium, nothing cut (48 layers, 24 heads of 64, 4
            codebooks, cross attention over 64 condition tokens of 768;
            1,838,507,520 parameters), served the same way on 4 x 1,000
            frames: 48 launches a generate (48 on ``flash_kernel_wg``),
            tokens (4, 32, 4) in the 2,048 codes;
29. xlstm  xlstm-125m, nothing cut (12 layers: mLSTM and sLSTM at layers 2
            and 8; 198,916,688 parameters), served the same way on 4 x
            1,000 tokens: no kernel launch at all (the recurrence is a
            per-step torch loop), the states finite; the launches of a
            profiled prefill (its first ``XLSTM_PROFILE_PROMPT`` positions)
            and decode step;
30. parity the reduced xLSTM, vision and audio models (float32) on the card
            and the CPU, as phase 25, and their loss and every gradient leaf
            as phase 21 (``RTOL_TRAIN_CPU``): one attention backward launch
            a layer for vision and audio, none for the xLSTM;
31. reqs   requirements from models: ``launch.dryrun.main(["--all"])``
            writes the 40 records of pod16x16 (10 architectures x 4 shapes,
            full width on the meta device, ``dryrun.JOBS`` processes; 32
            ok, 8 ``long_500k`` skipped), every ok one with collectives
            counted from the port's sharded step (bytes > 0);
            ``roofline.load_table`` reads 32 rows, and the collective term's
            part of each row's bound prints; one ``api.explore`` on
            the card over the 20 train_4k and decode_32k ``arch_task``s
            with ``benchmarks/arch_dse.py``'s space and policy
            (``ARCH_MEM_TYPES``, ``ARCH_PREFERENCE``): the retention kernel
            dispatched (``kernels.dispatch.retention.cuda`` rises, the plain
            count does not), the labels equal to the same ``explore`` on the
            CPU; its cold and warm wall time and a warm call profiled; the
            picks that move against the same records with no collective
            term;
            ``compose`` + ``simulate_report(traces=arch_traces(...))`` of
            qwen3-8b/decode_32k on the card and the CPU: orders equal,
            ``sim_*`` within ``RTOL_SIM``; ``memory_dse_annotate`` on the
            card stamps every ok record with the labels of the same
            ``explore`` (the reference's paper grid and policy) on the CPU;
32. sharded multi-card training (``sharded_phase``): one worker process a
            visible card (``launch.spmd.launch``, NCCL, a timeout; a
            worker's failure fails the run) on a ("data", "model") mesh of
            (2, 2) on 4 cards and (1, 1) on one (printed); each run trains
            two steps (lr 0, then lr > 0) sharded and on one card from the
            same weights and batch (phase 20's batch, lr and warmup). At
            full width in float32 cut to 2 layers: hymba-1.5b,
            moonshot-v1-16b-a3b (1 dense, 1 MoE layer, capacity factor E /
            k) with ``REPRO_MOE_SHARDMAP=1`` (expert parallelism) and
            without (the gathered block), and deepseek-v3-671b cut as phase
            33 cuts it (MLA's 128 heads split over "model": 4 forward and 2
            backward launches a step): loss and grad_norm within
            ``RTOL_SHARDED_STEP``, the AdamW moments within
            ``RTOL_SHARDED_GRAD``, the parameters within
            ``RTOL_SHARDED_UPDATE`` lr where the moment is above its noise
            (``RTOL_SHARDED_FLIPS``); hymba-1.5b at full width and depth
            (bf16). On more than one card the moonshot runs and full hymba
            also measure one card's own 2-microbatch gap, and each of their
            gaps may be up to ``SHARDED_NOISE_FACTOR`` times it. Full
            hymba's step launches both forward kernels and both backward
            kernels on
            every rank's shards; 2 warm steps timed (seconds, tokens/s,
            MFU over every card) with each card's peak memory, and one
            more under ``torch.profiler`` on rank 0 for NCCL's share of
            the device time. On (1, 1) every run is bit-equal to one
            card's. On 4 or more cards, moonshot-v1-16b-a3b at
            ``SHARDED_DEEP_LAYERS`` layers, which one card cannot hold,
            trains the same way (times, peak memory, NCCL share);
33. train-mla deepseek-v3-671b at full width in bf16 cut to its first 2
            layers (both dense) without the MTP module (``TRAIN_MLA``:
            3,020,332,032 parameters), trained as phase 20 for
            ``TRAIN_MLA_STEPS`` steps on phase 20's batch: every loss and
            grad_norm finite, 4 forward (on ``flash_kernel_wg``) and 2
            backward attention launches a step at (192, 128), no plain
            dispatch; step seconds, tokens/s,
            peak memory, MFU and a profiled warm step;
34. dense-attn the flash-attention kernel against its plain version at the
            dense family's prefill shapes (``DENSE_ATTN_SHAPES``, heads of
            128 on ``flash_kernel_wg`` in bf16): internlm2-1.8b (4, 16, 8,
            1,000), qwen3-8b (4, 32, 8, 1,000), qwen3-32b (4, 64, 8,
            1,000) and granite-34b's MQA (4, 48, 1, 1,000), as phase 22:
            float32 and bf16, both treatments of p, phase 8's gates; each
            one's time (p in float32 and rounded), bound, the plain
            version's and SDPA's, and the kernel's registers and spills;
35-38. dense granite-34b (88 layers, MQA, the tanh-GELU MLP), qwen3-32b
            (64, qk-norm), qwen3-8b (36, qk-norm) and internlm2-1.8b (24),
            nothing cut (``DENSE_SERVE``: the two 61-63 GiB models first),
            served as phase 23 twice: one ``flash_kernel_wg`` launch a
            layer a prefill, no plain dispatch, identical tokens, logits
            and caches finite; init seconds, prefill seconds first and
            warm, decode tokens/s, peak memory, a decode step beside its
            least time (every bf16 weight read once), a profiled prefill
            and decode step; each model freed before the next;
39. parity the four reduced dense models (float32) on the card and the CPU,
            as phase 25: identical greedy tokens, logits within the larger
            of ``RTOL_SERVE_CPU`` and ``SERVE_NOISE_FACTOR`` times the
            model's own float32 noise on the card (``serve_noise``: its
            logits with every weight moved by half an ulp), the loss and
            every gradient leaf within ``RTOL_TRAIN_CPU``, one attention
            backward launch a layer;
40. train-dense internlm2-1.8b at full width and depth in bf16
            (1,889,110,016 parameters), trained as phase 20 for
            ``TRAIN_DENSE_STEPS`` steps on phase 20's batch (the dense
            family's first single-card training through the (128, 128)
            backward): 48 forward (on ``flash_kernel_wg``: each layer's
            forward and its recomputation under remat ``full``) and 24
            backward attention launches a step (all 24 on the wgmma pair
            ``kflash.backward_kernel`` names, counted in
            ``flash_attention_bwd.wg_launches``), no plain dispatch; step
            seconds, tokens/s, peak memory, MFU and a profiled warm step;
41. examples ``scripts/smoke_models_torch.py``'s ``main`` over the 10
            reduced archs (finite, no plain dispatch) and the four
            ``examples/torch_*.py`` on the card's default device, writing
            into a temporary directory: the quickstart (DRC and LVS
            clean), the heterogeneous DSE (Table 2 with 7 x "OK"),
            serving the reduced hymba (attention and scan kernels, greedy
            determinism) and ``EXAMPLE_TRAIN_STEPS`` supervised training
            steps (its own "loss decreased" check, no restart); each
            one's seconds and kernel launches;
42. analysis the port's analyzer (``repro_torch.analysis``) on the card:
            the AST tier and the docs checks against the committed
            baseline; LG01 over every static shape profile; LG02-LG04,
            every library and route of ``lg.card_profiles`` launched twice
            directly in guarded buffers (no sentinel left, no guard band or
            input touched, no NaN where the plain version is finite, bit-
            equal twice); DT on CUDA tensors; RC: two drives of every entry
            point build and load nothing new, and no library was built twice
            in this process; LG05 for every route the drive launched
            (``capture``); and the host-sync witness: a warm ``explore``,
            ``compose``, ``simulate`` and the reduced hymba's decode and
            train step under ``torch.cuda.set_sync_debug_mode("warn")``,
            each sync attributed to its line in the port, every line
            flagged by the static HS tier (a finding, a ``# noqa: HSxx`` or
            a baseline entry; a sync with no frame of the port is never
            flagged). It prints the findings per family, each path's syncs,
            those with no frame of the port and the top three sites, the
            guarded launches and its seconds, and fails on any active
            finding or unflagged sync;
43. train-vision phi-3-vision-4.2b at full width and depth in bf16
            (3,833,662,464 parameters, 32 layers of 32 heads of 96), trained
            as phase 20 for ``TRAIN_VISION_STEPS`` steps on phase 20's batch
            (576 patches of 1,024 through the projector and 552 text
            tokens; the loss over the text): every loss and grad_norm
            finite; 64 forward attention launches a step, all on
            ``flash_kernel_wg``, and 32 backward ones, all on the
            two-warpgroup wgmma pair at (96, 96); no plain dispatch; step
            seconds, tokens/s, peak memory, MFU and a profiled warm step
            with the attention backward's share.

Each phase prints its seconds. It prints one ``{"kernels": [...]}`` line,
then, last, the ``{"ok": true, "device": {...}}`` line.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT / "tests"))     # torch_sharded_checks

RTOL_KERNEL = 1e-5      # kernel vs plain version (the Pallas kernel's gate)
RTOL_CPU = 2e-6         # table on the card vs the same table on the CPU
PEAK_FP32_OPS = 67e12   # H100 SXM fp32 outside the tensor cores [op/s]
PEAK_BYTES = 3.35e12    # H100 SXM HBM3 [B/s]
# H100 SXM special-function unit: 16 results per SM per clock (the CUDA C++
# Programming Guide's arithmetic-instruction throughput table, compute
# capability 9.0), on 132 SMs at the 1.98 GHz boost clock that
# PEAK_FP32_OPS also assumes (132 x 128 lanes x 2 x 1.98e9 = 66.9e12)
PEAK_SFU_OPS = 132 * 16 * 1.98e9
# fp32 operations of an exponential computed on the FMA pipe instead of the
# SFU: a range reduction and a degree-6 polynomial for 2^x, 12 instructions,
# each counted as one operation (so the operations' time stays a least time)
EXP_FMA_OPS = 12
# fp32 operations per row per RK4 step of the function (counted as the
# plain version writes it): four derivative evaluations of 26 arithmetic
# ops (3 of them divisions) and 4 transcendental calls each (2 exp, 2
# log1p), plus 21 ops for dt, the stage inputs, the update, the clip and the
# crossing test. Each division and transcendental call counts as one
# operation, so the bound is a least time. The crossing step adds 9 ops and
# 3 transcendentals once per row. Exponentials: 2 a derivative evaluation
# and 1 at the crossing (log and log1p not counted, so this count too gives
# a least time).
OPS_PER_STEP = 4 * (26 + 4) + 21
OPS_PER_CROSSING = 9 + 3
EXP_PER_STEP, EXP_PER_CROSSING = 4 * 2, 1

KERNELS = ("retention", "ssm_scan", "ssm_scan_bwd", "flash_attention",
           "flash_attention_bwd")
# phase 13: the corners of the retention kernel's corner checks
KERNEL_CORNERS = ("hot", "cold", "low_vdd", (1.2, 233.0))
# phase 15: the vdd sweep point of tests/golden/table2_vdd.json, the
# settings of tests/golden/table2_nlevel.json, and the gate of the golden
# metrics (the golden's task-3 swept p_w is one float32 ulp from the
# reference's own live value)
VDD_SWEEP_POINT = (1.2, 233.0)
NLEVEL_POLICIES = {
    "preference": {},
    "power_bb": {"objective": "power", "candidate_mode": "all_feasible",
                 "search": "branch_and_bound"},
}
RTOL_GOLDEN = 1e-5
# phase 16: the replayed sim_* metrics on the card against the CPU (float32
# on both; the tables' own card-vs-CPU gap is <= RTOL_CPU, and the drift's
# exponential rounds apart on the two devices)
RTOL_SIM = 1e-5
SIM_J, SIM_S = 65536, 4
# phase 17: the 200-step sizing on the card against the CPU (float32 exp
# and log round apart on the two devices)
RTOL_GRAD = 1e-4
FACADE_MACRO = {"mem_type": "gc_ossi", "word_size": 64, "num_words": 128}
PEAK_BF16_TC = 989e12   # H100 SXM bf16 dense on the tensor cores [FLOP/s]
# kernel vs plain version: the reference's gates for its Pallas kernels
TOL_ATTN = {"float32": 2e-5, "bfloat16": 2e-2}
# bf16 attention with p in float32 (round_p=False): every element within one
# bf16 ulp of the larger of the two values, magnitudes below
# ref.ULP_FLOOR * max|plain| counted as that (float32 rounding is relative
# to the output's scale, not to an element that cancels to near zero), and
# at most 1 % of the elements differing at all
MAX_ULPS_P_F32, MAX_SHARE_P_F32 = 1.0, 0.01
TOL_SSM = 1e-4
# reduced hymba on the card vs on the CPU, max|card - cpu| / max|cpu| over
# every step's logits (float32 on both; TF32 is off)
RTOL_SERVE_CPU = 1e-4
# phase 39: the reduced internlm2-1.8b and granite-34b (no qk-norm) at
# these weights and prompts carry float32 rounding up to ~1e-4 of their
# logits: JAX's own logits move by 2.4e-4 / 1.4e-4 over the same 24 steps
# when every weight moves by half an ulp (tests/test_torch_dense.py's
# note). Phase 39 measures that noise on the card (``serve_noise``) and
# holds card vs CPU within the larger of RTOL_SERVE_CPU and
# SERVE_NOISE_FACTOR times it, as phase 32 holds its runs to a measured
# noise; where the noise is below RTOL_SERVE_CPU / SERVE_NOISE_FACTOR
# (qwen3's qk-norm) the gate stays RTOL_SERVE_CPU
SERVE_NOISE_FACTOR = 10
# full-width decode vs prefill, float32, depth <= 2: max|decode - prefill| /
# max|prefill| of the last logits (measured 1.5e-5; a cache fault is O(1))
RTOL_DECODE_PREFILL = 1e-3
# the serving cell of phases 9 and 23-29: 4 prompts of 1,000 positions (a
# vision model's 576 patches among them), 32 greedy steps
SERVE_REQUESTS, SERVE_PROMPT, SERVE_STEPS, SERVE_MAX_SEQ = 4, 1000, 32, 1040
# (B, H, K, S, D) for the attention checks: the reference's shapes
# (tests/test_kernels.py), a ragged S, GQA, and hymba's prefill (25 q heads
# on 5 kv heads, 128 meta tokens + the 1,000-token prompt)
ATTN_SHAPES = [(1, 2, 2, 256, 64), (2, 1, 1, 128, 128), (1, 4, 4, 512, 64),
               (2, 2, 2, 256, 96), (2, 4, 4, 200, 64), (1, 6, 2, 77, 32),
               (4, 25, 5, 1128, 64)]
# (B, H, K, S, D, window, sink), causal: a window with a sink no tile
# boundary meets, ragged S with GQA, a window >= S, hymba's serving prefill
# (window 1,024 and 128 meta tokens: at S = 1,128 the mask is the causal
# one) and a longer prompt where the window cuts and tiles are skipped
ATTN_MASK_CASES = [(1, 4, 2, 300, 64, 100, 20), (2, 6, 2, 517, 128, 128, 70),
                   (1, 4, 4, 256, 16, 1000, 16), (1, 5, 5, 190, 96, 64, 0),
                   (4, 25, 5, 1128, 64, 1024, 128),
                   (1, 25, 5, 2176, 64, 1024, 128)]
# (B, S, di, n) for the scan checks: the reference's shapes, a di no block
# divides, hymba's full width (di = 2 x 1600, n = 16, S = 128 + 1,000), n =
# 4 and 32 (the other instantiations), S = 1, B = 1 at hymba's di, and S one
# past a 32-step staging round
SSM_SHAPES = [(1, 128, 256, 16), (2, 256, 512, 8), (1, 64, 1024, 16),
              (2, 45, 200, 8), (4, 1128, 3200, 16), (2, 100, 384, 4),
              (1, 70, 256, 32), (3, 1, 3200, 16), (1, 1128, 3200, 16),
              (2, 33, 200, 16)]
# Bounds of the two serve kernels, counted from their function (not from
# what the kernels do):
# - flash attention: the scores the mask leaves (causal: S(S+1)/2 per
#   (batch, head), fewer with a window); 2 Dqk flops for q.k and 2 Dv for
#   p.v each (Dqk = Dv but in MLA), on the bf16 tensor-core peak (the same
#   count with p in float32: the function is the same, its precision is not
#   work); 5 fp32 ops per score (scale, mask, max, exp, sum) on the fp32
#   peak; bytes: q, k, v read once and o written once. The least time is
#   the largest of the three.
# - selective scan: per (b, t, channel) and state, 7 fp32 ops (dt*A, exp,
#   a*h, dt*x*B as 2, the add, h*C and its sum, each transcendental counted
#   as one) and one exponential, plus 3 per (b, t, channel)
#   (dt*x, D*x, the add); bytes: x, dt, B, C, A, D read once, y and h_final
#   written once.
ATTN_FLOPS_PER_SCORE_DIM = 2
ATTN_ELEM_OPS_PER_SCORE = 5
SSM_OPS_PER_STATE, SSM_OPS_PER_CHANNEL = 7, 3
# ... and of the two backward kernels:
# - flash attention backward: per visible score 2D flops each for S (p is
#   not an input: it is recomputed), dK and dQ, and 2Dv each for dP and dV
#   (Dv the value head dim: 10D a score where Dv = D, 6D + 4Dv for MLA) on
#   the bf16 peak; 5 fp32 ops per score (exp, the lse subtraction, dP -
#   Delta, the product, the mask) and 2Dv per row for Delta on the fp32
#   peak; bytes: q, k, v, o, dO and lse read once, dq, dk, dv written once;
# - selective scan backward: per (b, t, channel) and state, 16 fp32 ops
#   (the state recomputed from the saved one: 2; the adjoint: 2; ddt's
#   term: 4; dx's: 1; dA's: 3; dB's and dC's: 2 each) and one exponential
#   (a_t), plus 4 per (b, t, channel) (dx, dD); bytes: x, dt, dy, B, C, A,
#   D and the saved states read once, dx, ddt, dA, dB, dC, dD written once.
ATTN_BWD_FLOPS_PER_SCORE_D, ATTN_BWD_FLOPS_PER_SCORE_DV = 6, 4
# the CUDA runtime and driver calls that put work on a stream, as
# torch.profiler names them
HOST_LAUNCH_CALLS = {"cudaLaunchKernel", "cudaLaunchKernelExC",
                     "cuLaunchKernel", "cuLaunchKernelEx", "cudaMemcpyAsync",
                     "cudaMemsetAsync"}
SSM_BWD_OPS_PER_STATE, SSM_BWD_OPS_PER_CHANNEL = 16, 4
# phase 19: the backward kernels against autograd of their plain versions,
# max|kernel - plain| / max|plain| per gradient: bf16 attention (both round
# dq, dk, dv to bf16; the kernel takes Delta from the bf16 o, the plain
# version differentiates the float32 accumulator), fp32 attention and the
# fp32 scan (summation order)
RTOL_ATTN_BWD = {"float32": 2e-5, "bfloat16": 1e-2}
RTOL_SSM_BWD = 1e-4
# (B, H, K, S, D, window, sink, dtype): hymba-1.5b's training shapes (the
# sliding-window layers; the global ones), internlm2-1.8b's (phase 40's
# batch: 16 heads of 128 on 8 kv heads; a dK/dV block sums a kv head's 2),
# moonshot-v1-16b-a3b's on the same batch (16 heads of 128, as many kv
# heads), phi-3-vision-4.2b's (phase 43's batch: 32 heads of 96, as many kv
# heads), granite-34b's MQA heads on one sequence (48 on one kv head: a
# dK/dV block a query head, fp32 partials and the dQ launch's combine),
# GQA at D = 96 under SUM_HEADS_BLOCKS dK/dV blocks (partials and the
# combine), D = 96 with a window and a sink, and small shapes in both
# dtypes (the reduced hymba's layer: window 16, 4
# meta tokens, D 16); the first ATTN_BWD_TIMED are bit-equal twice and
# timed
ATTN_BWD_TIMED = ("SWA", "global", "internlm2", "moonshot", "phi")
ATTN_BWD_CASES = [(4, 25, 5, 1128, 64, 1024, 128, "bfloat16"),
                  (4, 25, 5, 1128, 64, None, 0, "bfloat16"),
                  (4, 16, 8, 1128, 128, None, 0, "bfloat16"),
                  (4, 16, 16, 1128, 128, None, 0, "bfloat16"),
                  (4, 32, 32, 1128, 96, None, 0, "bfloat16"),
                  (1, 48, 1, 1128, 128, None, 0, "bfloat16"),
                  (1, 8, 2, 1128, 96, None, 0, "bfloat16"),
                  (2, 4, 2, 300, 96, 100, 20, "bfloat16"),
                  (2, 4, 2, 300, 64, 100, 20, "bfloat16"),
                  (2, 4, 2, 300, 64, 100, 20, "float32"),
                  (4, 4, 2, 68, 16, 16, 4, "float32")]
# (B, S, di, n): hymba-1.5b's full width; the reduced hymba's scan; a di no
# block divides and an S no saved-state interval divides
SSM_BWD_SHAPES = [(4, 1128, 3200, 16), (4, 68, 128, 8), (2, 193, 200, 16)]
# (B, H, K, S, Dqk, Dv, dtype): the attention backward at MLA's head dims:
# deepseek-v3's training shape (128 heads, query/key 192, value 128, 1,000
# positions), a ragged S, and the reduced MLA's 24 / 16 (q and k padded to
# 32), each in bf16 and float32; the first two are bit-equal twice, and the
# bf16 one is timed
MLA_BWD_CASES = [(4, 128, 128, 1000, 192, 128, "bfloat16"),
                 (4, 128, 128, 1000, 192, 128, "float32"),
                 (1, 16, 16, 333, 192, 128, "bfloat16"),
                 (1, 16, 16, 333, 192, 128, "float32"),
                 (2, 4, 4, 40, 24, 16, "bfloat16"),
                 (2, 4, 4, 40, 24, 16, "float32")]
# phase 19's times: the median of this many time_ms readings, each of 20
# calls queued behind a sleep of QUEUE_CYCLES card cycles (~10 ms, longer
# than the host takes to queue them)
TIME_REPEATS = 5
# kernel_split_ms: the calls in a profiled window, and the windows tried
# before a kernel's device time is written down as not measured (a window
# of a few ms has come back holding no device record of its kernels)
SPLIT_CALLS, SPLIT_WINDOWS = 20, 3
QUEUE_CYCLES = 20_000_000
# SDPA's backward as the yardstick, pinned to the first of these backends
# that runs (names of torch.nn.attention.SDPBackend)
SDPA_BACKENDS = ("CUDNN_ATTENTION", "FLASH_ATTENTION", "EFFICIENT_ATTENTION")
# phase 20: full-width training of hymba-1.5b
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS, TRAIN_LR = 4, 1128, 8, 1e-3
# phase 33: deepseek-v3-671b at full width trained on phase 20's batch,
# cut to its first 2 layers (both dense; MLA at (192, 128)) without the MTP
# module: 3,020,332,032 parameters, ~36 GB at 12 bytes each (bf16
# parameters and gradients, float32 moments). A cut that keeps an MoE layer
# or the MTP module (~11.5 B parameters each) does not fit one card for
# training
TRAIN_MLA = ("deepseek-v3-671b",
             {"num_layers": 2, "first_dense_layers": 2, "mtp": False})
TRAIN_MLA_STEPS = 4
# phase 21: the reduced hymba's loss and every gradient leaf on the card
# against the CPU (float32; the gap grows through the 4 random-weight
# layers as it does between the port and JAX on the CPU, 3.9e-4 there:
# tests/test_torch_train.py), and a supervised 6-step run with a failure
# injected at step 4
RTOL_TRAIN_CPU = {"loss": 1e-5, "grads": 2e-3}
# phase 22: (B, H, K, S, Dqk, Dv) for the flash-attention checks of the MoE
# family and the rest of the dense family: moonshot-v1-16b-a3b's prefill
# (16 heads of 128, as many kv heads), granite-34b's MQA (48 q heads on one
# kv head), deepseek-v3's MLA (128 heads, query/key 192 = nope 128 + rope
# 64, value 128) at the serving prompt and on a ragged S, and the reduced
# deepseek's (24 / 16: the wrapper pads q and k to 32); the first four are
# full-width shapes, timed
MOE_ATTN_SHAPES = [(4, 16, 16, 1000, 128, 128), (1, 48, 1, 512, 128, 128),
                   (4, 128, 128, 1000, 192, 128), (1, 16, 16, 333, 192, 128),
                   (2, 4, 4, 40, 24, 16)]
# phases 23-24: the MoE models served at full width, (arch, layers kept;
# None = all): moonshot-v1-16b-a3b whole (27.98 B parameters, 52.1 GiB in
# bf16) and deepseek-v3-671b cut to its 3 dense layers and 1 MoE layer, the
# MTP module in the tree (26.72 B of its 682.6 B parameters)
MOE_SERVE = (("moonshot-v1-16b-a3b", None), ("deepseek-v3-671b", 4))
# phase 26: (B, H, K, S, D) of the attention kernel at phi-3-vision-4.2b's
# prefill (576 patches + 424 text tokens; 32 heads of 96, as many kv heads)
# and musicgen-medium's (1,000 frames; 24 heads of 64), both timed
FAMILY_ATTN_SHAPES = [(4, 32, 32, 1000, 96), (4, 24, 24, 1000, 64)]
# phases 27-29: the last three families served at full width and depth
FAMILY_SERVE = ("phi-3-vision-4.2b", "musicgen-medium", "xlstm-125m")
# phase 34: (B, H, K, S, D) of the attention kernel at the dense family's
# prefill (4 prompts of 1,000 tokens, heads of 128): internlm2-1.8b (16
# heads on 8 kv heads), qwen3-8b (32 on 8), qwen3-32b (64 on 8) and
# granite-34b (48 on one: MQA), all timed
DENSE_ATTN_SHAPES = [(4, 16, 8, 1000, 128), (4, 32, 8, 1000, 128),
                     (4, 64, 8, 1000, 128), (4, 48, 1, 1000, 128)]
# phases 35-38: the dense family served at full width and depth (bf16
# weights 63.26, 61.02, 15.26 and 3.52 GiB), the two largest first, while
# the caching allocator holds no block a smaller model left behind
DENSE_SERVE = ("granite-34b", "qwen3-32b", "qwen3-8b", "internlm2-1.8b")
# phase 40: internlm2-1.8b trained at full width and depth on phase 20's
# batch (1.89 B parameters, ~23 GB at 12 bytes each)
TRAIN_DENSE, TRAIN_DENSE_STEPS = "internlm2-1.8b", 4
# phase 43: phi-3-vision-4.2b trained at full width and depth on phase 20's
# batch (576 patches and 552 text tokens a row), nothing cut: its
# parameters (phase 27's count), ~46 GB at 12 bytes each
TRAIN_VISION, TRAIN_VISION_STEPS = "phi-3-vision-4.2b", 4
TRAIN_VISION_PARAMS = 3_833_662_464
# phase 41: the train example's steps (at 50 or more it checks that the
# loss decreased)
EXAMPLE_TRAIN_STEPS = 50
# the xLSTM prefill makes ~257 launches a position (its per-step loop):
# tracing all 1,000 positions (256,650 launches) takes ~150 s, so its
# profiled prefill is the first XLSTM_PROFILE_PROMPT positions
XLSTM_PROFILE_PROMPT = 100
# phase 31: benchmarks/arch_dse.py's extended space and policy (OS-OS, as
# the paper's Future Work adds it; refreshed gain cells for hour-lived
# weights) over every train_4k and decode_32k record, and the cell whose
# requirements phase 31 composes and re-ranks by trace replay
ARCH_MEM_TYPES = ("sram6t", "gc_sisi", "gc_ossi", "gc_osos", "gc_osos_hvt")
ARCH_PREFERENCE = ("os-os", "os-si", "si-si", "sram")
ARCH_SHAPES = ("train_4k", "decode_32k")
ARCH_SIM_CELL = ("qwen3-8b", "decode_32k")
# the dry-run's 10 architectures x 4 shapes: long_500k is skipped for
# every one but the two sub-quadratic ones (hymba-1.5b, xlstm-125m)
DRYRUN_CELLS = {"ok": 32, "skipped": 8}
# phase 32: the sharded step against one card from the same weights and
# batch, two steps (lr 0, then lr > 0). At full width in float32 and cut to
# 2 layers, where the step is well conditioned, the gates of
# tests/test_torch_train.py (RTOL_STEP's loss and grad_norm; RTOL_GRAD at 4
# layers for the moments) and of tests/test_torch_sharding.py for the
# parameters (within RTOL_SHARDED_UPDATE lr where the moment is above its
# noise, apart by more than lr / 10 in at most RTOL_SHARDED_FLIPS of the
# entries). Where a run also measures one card's own reorder noise (the
# same steps in 2 microbatches, in the same run), each gap may instead be
# up to SHARDED_NOISE_FACTOR times that noise's: hymba-1.5b at its full
# depth and dtype, whose random-init bf16 step moves by its own size under
# any reordered sum (tools/step_reorder_gaps.py), and moonshot-v1-16b-a3b,
# whose top-k routing turns on the rounding of its inputs. moonshot's runs
# set the capacity factor to E / k, so that no entry drops either way (an
# expert-parallel rank takes its capacity from its local tokens, one card
# from all of them) and microbatching reorders the same sums.
# SHARDED_DEEP_LAYERS: the depth of moonshot that only 4 cards hold (12
# layers: 7.2 B parameters at 12 B each in the port's dtypes, bf16
# parameters and gradients and float32 moments, 86 GB before
# activations); the launch's time limit
RTOL_SHARDED_STEP = {"loss": 1e-5, "grad_norm": 2e-3}
RTOL_SHARDED_GRAD = 2e-3
RTOL_SHARDED_UPDATE, RTOL_SHARDED_FLIPS = 0.1, 1e-3
SHARDED_NOISE_FACTOR = 10
SHARDED_DEEP_LAYERS = 12
SHARDED_TIMEOUT = 900


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def nominal_rows(device):
    """(14, 10) packed kernel rows of the 7 bitcells x level shifter."""
    import torch
    from repro_torch.core import bitcells, retention
    cells = bitcells.stack_bitcells().to(device)
    return torch.cat([retention.pack_retention_params(
        cells, torch.full((7,), float(ls), device=device)) for ls in (0, 1)])


def perturbed_rows(base, n: int, seed: int):
    """``n`` rows drawn from ``base`` with log-uniform factors in
    [0.1, 10] on ispec, i_floor, c_sn and w, and vt shifted by up to
    +-50 mV."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    b = base.cpu().numpy().astype(np.float64)
    p = b[rng.integers(0, b.shape[0], n)]
    for field in (2, 4, 6, 7):
        p[:, field] *= 10.0 ** rng.uniform(-1.0, 1.0, n)
    p[:, 0] += rng.uniform(-0.05, 0.05, n)
    return torch.from_numpy(p.astype(np.float32)).to(base.device)


def compare_kernel(params, ts, ut=None, corner="nominal"):
    """Kernel vs plain version on the same inputs, at thermal voltage ``ut``
    (None: the nominal one); returns (max abs err, max rel err)."""
    import torch
    from repro_torch.kernels import ref, retention
    ut = ref.UT if ut is None else ut
    got = retention.retention_batch(params, ts, ut)
    want = ref.retention_ref(params, ts, ut)
    torch.cuda.synchronize()
    where = f"B={params.shape[0]} at {corner} (ut {ut:.6g} V)"
    if not torch.isfinite(got).all():
        fail(f"kernel output not finite at {where}")
    abs_err = (got - want).abs()
    rel_err = (abs_err / want.abs()).max().item()
    if rel_err > RTOL_KERNEL:
        fail(f"kernel vs plain at {where}: max rel err {rel_err:.3e} > "
             f"{RTOL_KERNEL}")
    start_crossed = params[:, 8] < params[:, 9]
    if not torch.equal(got[start_crossed], want[start_crossed]):
        fail(f"start-crossed rows differ at {where}")
    print(f"kernel {where}: max rel err {rel_err:.3e}, max abs err "
          f"{abs_err.max().item():.3e} s, start-crossed rows "
          f"{int(start_crossed.sum())} exact", flush=True)
    return abs_err.max().item(), rel_err


def phase_done(n: int, name: str, t0: float) -> None:
    print(f"phase {n} ({name}): {time.perf_counter() - t0:.2f} s",
          flush=True)


def compare_tables(label, card, cpu):
    """Every metric column of a table built on the card within RTOL_CPU of
    the same table built on the CPU; returns the worst relative gap."""
    import numpy as np
    if card.metric_names != cpu.metric_names:
        fail(f"{label}: columns differ between card and CPU")
    worst = 0.0
    for name in cpu.metric_names:
        a = np.asarray(card[name], np.float64)
        b = np.asarray(cpu[name], np.float64)
        rel = np.abs(a - b) / np.maximum(np.abs(b), np.finfo(np.float64).tiny)
        worst = max(worst, float(rel.max()))
        if not np.allclose(a, b, rtol=RTOL_CPU, atol=0.0):
            fail(f"{label} column {name}: card vs CPU max rel "
                 f"{rel.max():.3e} > {RTOL_CPU}")
    return worst


def max_rel(got, want) -> float:
    """Largest |got - want| / |want| over the finite, nonzero entries; inf
    and 0 must sit in the same places."""
    import numpy as np
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    fin = np.isfinite(want) & (want != 0)
    if not np.array_equal(np.isfinite(got), np.isfinite(want)) or \
            not np.array_equal(got[~fin], want[~fin]):
        return float("inf")
    if not fin.any():
        return 0.0
    return float(np.max(np.abs(got[fin] - want[fin]) / np.abs(want[fin])))


def sim_gap(got, want) -> float:
    """Worst relative gap over every sim_* metric, combined and per phase."""
    from repro_torch.sim import SIM_METRICS
    gaps = [max_rel(got[m], want[m]) for m in SIM_METRICS]
    gaps += [max_rel(got["phases"][p][m], want["phases"][p][m])
             for p in want["phases"] for m in SIM_METRICS]
    return max(gaps)


def picks_of(selections):
    """(task, level, [(family, row)]) of an explore report's selections."""
    return [(tid, lvl, [(p.family, p.config_idx) for p in sel.picks])
            for tid, levels in selections.items()
            for lvl, sel in levels.items()]


def time_ms(fn, iters: int, warmup: int, queued: bool = False) -> float:
    """Mean ms per call of ``fn`` over ``iters`` calls, CUDA events. With
    ``queued`` the card first sleeps (``QUEUE_CYCLES``) while the host
    queues every call, so that a call shorter than its host-side cost is
    timed by its device work alone."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if queued:
        torch.cuda._sleep(QUEUE_CYCLES)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def least_time(nbytes, fp32_ops, exps):
    """(bound ms, 'bytes' | 'operations', {term: ms}): the larger of the
    bytes over the memory rate and the operations' least time.

    ``fp32_ops`` counts each exponential as one operation. Each of the
    ``exps`` exponentials runs on the SFU or, at ``EXP_FMA_OPS`` more
    operations, on the FMA pipe, so the operations take the fp32 work over
    the fp32 peak or, where the SFU alone would take longer, the work of
    both pipes over their joint rate (the split at which both finish
    together). ``sfu`` (every exponential on the SFU) is a per-pipe
    reading, not part of the bound."""
    t_fp32, t_sfu = fp32_ops / PEAK_FP32_OPS, exps / PEAK_SFU_OPS
    t_ops = t_fp32 if t_sfu <= t_fp32 else (
        (fp32_ops + EXP_FMA_OPS * exps)
        / (PEAK_FP32_OPS + EXP_FMA_OPS * PEAK_SFU_OPS))
    terms = {"bytes": nbytes / PEAK_BYTES * 1e3, "fp32": t_fp32 * 1e3,
             "sfu": t_sfu * 1e3, "operations": t_ops * 1e3}
    by = "bytes" if terms["bytes"] >= terms["operations"] else "operations"
    return terms[by], by, terms


def bound(params, ts, out):
    """``least_time`` of one retention launch on these inputs."""
    B, n_steps = params.shape[0], ts.shape[0] - 1
    crossed = int(((out < ts[-1]) & (params[:, 8] >= params[:, 9])).sum())
    ops = B * n_steps * OPS_PER_STEP + crossed * OPS_PER_CROSSING
    exps = B * n_steps * EXP_PER_STEP + crossed * EXP_PER_CROSSING
    nbytes = params.numel() * 4 + ts.numel() * 4 + B * 4
    return least_time(nbytes, ops, exps)


def visible_scores(S, window=None, sink=0):
    """Scores the causal (+ window, sink) mask leaves in an S x S block:
    row r sees min(r + 1, window) keys of its window and the sink keys
    below it, min(sink, r - window + 1) when that is positive."""
    import numpy as np
    r = np.arange(S, dtype=np.int64)
    if window is None:
        return int((r + 1).sum())
    return int((np.minimum(r + 1, window)
                + np.clip(np.minimum(sink, r - window + 1), 0, None)).sum())


def attn_bound(B, H, K, S, D, itemsize, window=None, sink=0, Dv=None):
    """(bound ms, 'bytes' | 'operations') of causal attention, (B,H,S,D)
    queries on (B,K,S,D) keys and (B,K,S,Dv) values (Dv = D unless given),
    counting only the scores the mask leaves."""
    Dv = D if Dv is None else Dv
    scores = B * H * visible_scores(S, window, sink)
    t_mm = scores * ATTN_FLOPS_PER_SCORE_DIM * (D + Dv) / PEAK_BF16_TC
    t_elem = scores * ATTN_ELEM_OPS_PER_SCORE / PEAK_FP32_OPS
    t_bytes = (B * H * S * (D + Dv) + B * K * S * (D + Dv)) * itemsize \
        / PEAK_BYTES
    t_ops = max(t_mm, t_elem)
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def ssm_bound(B, S, di, n):
    """``least_time`` of the selective scan, float32."""
    ops = B * S * di * (SSM_OPS_PER_STATE * n + SSM_OPS_PER_CHANNEL)
    nbytes = 4 * (3 * B * S * di + 2 * B * S * n + di * n + di + B * di * n)
    return least_time(nbytes, ops, B * S * di * n)


def attn_inputs(shape, dtype, seed, device):
    """q (B,H,S,D), k (B,K,S,D), v (B,K,S,Dv) unit normal from ``seed``;
    ``shape`` (B, H, K, S, D) or (B, H, K, S, D, Dv)."""
    import numpy as np
    import torch
    B, H, K, S, D = shape[:5]
    Dv = shape[5] if len(shape) > 5 else D
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.normal(size=(B, h, S, d)).astype(
        np.float32)).to(device, dtype) for h, d in ((H, D), (K, D), (K, Dv)))


def ssm_inputs(shape, seed, device):
    import numpy as np
    import torch
    B, S, di, n = shape
    rng = np.random.default_rng(seed)
    arrays = (rng.normal(size=(B, S, di)),
              rng.uniform(0.001, 0.1, size=(B, S, di)),
              -rng.uniform(0.5, 2.0, size=(di, n)),
              rng.normal(size=(B, S, n)), rng.normal(size=(B, S, n)),
              rng.normal(size=(di,)))
    return tuple(torch.from_numpy(np.asarray(a, np.float32)).to(device)
                 for a in arrays)


def record_steps(engine):
    """Wrap an engine's prefill and decode steps so that a ``generate``
    records the prefill's seconds (host clock between two synchronizes),
    every step's logits and the last decode step's cache; what the steps
    compute is unchanged."""
    import torch
    rec = {"prefill_s": [], "logits": [], "cache": None}
    prefill, decode = engine._prefill, engine._decode

    def sync():
        torch.cuda.synchronize()

    def timed_prefill(params, batch):
        sync()
        t0 = time.perf_counter()
        cache, logits = prefill(params, batch)
        sync()
        rec["prefill_s"].append(time.perf_counter() - t0)
        rec["logits"].append(logits)
        return cache, logits

    def recorded_decode(params, cache, batch):
        logits, cache = decode(params, cache, batch)
        rec["logits"].append(logits)
        rec["cache"] = cache
        return logits, cache

    engine._prefill, engine._decode = timed_prefill, recorded_decode
    return rec


def decode_vs_prefill(lm, params, toks, n_prompt, max_seq):
    """Prefill toks[:, :n_prompt], decode the rest one by one, and compare
    the last logits with a prefill of all of toks: (max abs gap, max |logit|
    of the prefill, share of requests whose argmax agrees)."""
    import torch
    with torch.inference_mode():
        cache, logits = lm.prefill(params, {"tokens": toks[:, :n_prompt]},
                                   max_seq=max_seq)
        for t in range(n_prompt, toks.shape[1]):
            logits, cache = lm.decode(params, cache, {"tokens": toks[:, t]})
        _, full = lm.prefill(params, {"tokens": toks}, max_seq=max_seq)
    logits, full = logits.float(), full.float()
    return ((logits - full).abs().max().item(), full.abs().max().item(),
            (logits.argmax(-1) == full.argmax(-1)).float().mean().item())


def to_leaves(tree):
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in to_leaves(v)]
    if isinstance(tree, (tuple, list)):
        return [t for v in tree for t in to_leaves(v)]
    return [tree]


def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def profile_report(label, fn):
    """Run ``fn`` once under ``torch.profiler``; print its wall time,
    device busy share, kernel launches and five largest device entries."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    # device-side events only (kernels, copies): an operator's entry also
    # carries the device time of the kernels it launched, so summing both
    # would count that time twice
    averages = prof.key_averages()      # seconds over a large trace: once
    kernels = [e for e in averages if e.device_type == DeviceType.CUDA]
    device_us = sum(e.self_device_time_total for e in kernels)
    launches = sum(e.count for e in kernels)
    # the launch and copy calls as the host made them: the device trace can
    # hold a few more or fewer records of the same calls from one profiled
    # window to the next (a warm explore: 971 or 985 with the same 137
    # copies and 88 gathers issued)
    host_calls = sum(e.count for e in averages
                     if e.device_type == DeviceType.CPU
                     and e.key in HOST_LAUNCH_CALLS)
    print(f"profile: {label} {wall_s:.4f} s wall, device busy "
          f"{device_us / 1e3:.4f} ms ({device_us / 1e4 / wall_s:.2f} %) in "
          f"{launches} kernel launches ({host_calls} launch and copy calls "
          f"from the host)")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:5]:
        print(f"  {e.self_device_time_total / 1e3:9.4f} ms  x{e.count:<5d} "
              f"{e.key[:90]}")
    return {"wall_s": wall_s, "device_ms": device_us / 1e3,
            "launches": launches, "host_calls": host_calls,
            "kernels": kernels}


def simulate_phase(ptable, seed: int):
    """Phase 16: the trace-replay re-rank on the card against the CPU (see
    the module docstring). Returns (stats, retention launches of a warm
    ``api.simulate``)."""
    import tempfile

    import numpy as np
    import torch
    from repro_torch import api, hetero, sim
    from repro_torch.core import corners as corners_mod
    from repro_torch.core import gainsight
    from repro_torch.core.select import Bucket, LevelReq, TaskReq
    from repro_torch.hetero import expand as expand_mod
    from repro_torch.kernels import retention as kretention
    from repro_torch.sim.rerank import composition_idx, sim_cols

    def sim_keys(rep):
        """Composition rows in re-rank order, and the smallest relative gap
        between adjacent simulated energies."""
        e = np.array([c.metrics["sim_e_total_j"] for c in rep.ranked])
        e = e[np.isfinite(e)]
        gap = float(np.min(np.abs(np.diff(e)) / np.abs(e[:-1]))) \
            if len(e) > 1 else float("inf")
        return composition_idx(rep).tolist(), gap

    def rep_gap(card, cpu):
        return max(max_rel([a.metrics[f"sim_{m}"] for a in card.ranked],
                           [b.metrics[f"sim_{m}"] for b in cpu.ranked])
                   for m in sim.SIM_METRICS)

    sim_stats = {"table2": {}, "launches_per_call": []}
    walls, t2, worst, key_gap = [], 0, 0.0, float("inf")
    for t in gainsight.TASKS:
        kretention.retention_batch.launches = 0
        n_replays = sim.sim_eval_count()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rep = api.simulate(task=t, device="cuda")
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        sim_stats["launches_per_call"].append(
            kretention.retention_batch.launches)
        if sim.sim_eval_count() != n_replays + 1:
            fail(f"simulate task {t.task_id}: not one replay")
        cpu_rep = api.simulate(task=t, device="cpu")
        rows, gap = sim_keys(rep)
        cpu_rows, _ = sim_keys(cpu_rep)
        key_gap = min(key_gap, gap)
        rel = rep_gap(rep, cpu_rep)
        worst = max(worst, rel)
        ok = rep.labels() == gainsight.TABLE2_EXPECTED[t.task_id]
        t2 += ok
        if not ok or rep.refined != "simulate" or rows != cpu_rows \
                or rel > RTOL_SIM:
            fail(f"simulate task {t.task_id} on the card: labels "
                 f"{rep.labels()}, refined {rep.refined}, order equal to "
                 f"the CPU's {rows == cpu_rows} (smallest key gap "
                 f"{gap:.3e}), sim metrics max rel {rel:.3e} (gate "
                 f"{RTOL_SIM})")
    if set(sim_stats["launches_per_call"]) != {1}:
        fail(f"simulate: retention launches per call "
             f"{sim_stats['launches_per_call']}, expected 1 (its table)")
    kretention.retention_batch.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    api.simulate(task=gainsight.TASKS[0], device="cuda")
    torch.cuda.synchronize()
    sim_warm_s = time.perf_counter() - t0
    sim_launches = kretention.retention_batch.launches
    sim_stats["table2"] = {"matches": f"{t2}/7", "first_s": walls[0],
                           "after_s": walls[1:], "warm_s": sim_warm_s,
                           "sim_max_rel_vs_cpu": worst,
                           "smallest_key_gap": key_gap}
    print(f"simulate: api.simulate(device='cuda') Table 2 {t2}/7, refined, "
          f"orders equal to the CPU's (smallest adjacent key gap "
          f"{key_gap:.3e}), sim metrics max rel {worst:.3e}; "
          f"{sim_launches} retention launch a call; {walls[0]:.4f} s "
          f"first, {sim_warm_s:.4f} s warm (tasks 2-7: "
          f"{min(walls[1:]):.4f}-{max(walls[1:]):.4f} s)", flush=True)

    # the 3-level task, where the simulated energy replaces the analytic power
    cpu_table = api.DesignTable.build(device="cpu")
    power = {"compose_policy": hetero.ComposePolicy(objective="power"),
             "sim_policy": sim.SimPolicy(objective="energy")}
    rep = api.simulate(ptable, gainsight.nlevel_task(3), device="cuda",
                       **power)
    cpu_rep = api.simulate(cpu_table, gainsight.nlevel_task(3),
                           device="cpu", **power)
    analytic = hetero.compose(ptable, gainsight.nlevel_task(3), device="cuda",
                              compose_policy=power["compose_policy"])
    rows, gap = sim_keys(rep)
    rel = rep_gap(rep, cpu_rep)
    if rows != sim_keys(cpu_rep)[0] or rel > RTOL_SIM:
        fail(f"3-level power/energy simulate on the card: order equal to "
             f"the CPU's {rows == sim_keys(cpu_rep)[0]} (smallest key gap "
             f"{gap:.3e}), sim metrics max rel {rel:.3e}")
    redecides = rows != composition_idx(analytic).tolist()
    sim_stats["nlevel_power"] = {"order_equal_cpu": True,
                                 "redecides": redecides,
                                 "smallest_key_gap": gap,
                                 "sim_max_rel_vs_cpu": rel}
    print(f"simulate: 3-level task, power/energy, {len(rows)} compositions: "
          f"order equal to the CPU's (smallest adjacent key gap {gap:.3e}), "
          f"re-decides the analytic order: {redecides}; sim metrics max rel "
          f"{rel:.3e}", flush=True)

    # the cold-boost case: the same GC macro at the base point and at the
    # (1.2 V, 233 K) block under the adaptive controller and a heating die
    def cold_boost(table, device):
        pts = ((None, None),
               (corners_mod.as_operating_point(VDD_SWEEP_POINT), None))
        metrics, fams = expand_mod.expand_metrics(table, table.metrics, pts,
                                                  device=device)
        n = len(table)
        gc = int(np.where((np.asarray(fams[:n]) != "sram6t")
                          & (np.asarray(metrics["retention_s"][:n])
                             < 1e-3))[0][0])
        cols = {k: np.asarray(metrics[k]) for k in
                ("bits", "e_read_j", "e_write_j", "f_op_hz", "p_leak_w",
                 "retention_s")}
        cols["word_bits"] = np.tile(np.asarray(table["word_size"],
                                               np.float64), 2)
        return cols, np.array([[gc], [n + gc]], np.int32)

    boost_task = TaskReq("cold", "cold", {"L1": LevelReq(
        "L1", 1 << 20, (Bucket(1.0, 1e8, 1e-3),))})
    boost_trace = [sim.phase_trace(boost_task, "decode", 1e-3, 16)]
    boost_policy = sim.SimPolicy(refresh=True, adaptive_refresh=True,
                                 temp_drift_k=30.0)
    card_cols, idx = cold_boost(ptable, "cuda")
    cpu_cols, cpu_idx = cold_boost(cpu_table, "cpu")
    boost = sim.simulate_traces(card_cols, idx, boost_trace,
                                policy=boost_policy, device="cuda")
    boost_cpu = sim.simulate_traces(cpu_cols, cpu_idx, boost_trace,
                                    policy=boost_policy, device="cpu")
    rel = sim_gap(boost, boost_cpu)
    e_ref = boost["e_refresh_j"]
    if not np.array_equal(idx, cpu_idx) or not e_ref[1] < e_ref[0] \
            or rel > RTOL_SIM:
        fail(f"cold boost on the card: e_refresh {e_ref} (cold block must "
             f"be below base), card vs CPU max rel {rel:.3e}")
    sim_stats["cold_boost"] = {"e_refresh_j": e_ref.tolist(),
                               "max_rel_vs_cpu": rel}
    print(f"simulate: cold boost, e_refresh {e_ref[0]:.4e} J at the base "
          f"block, {e_ref[1]:.4e} J at (1.2 V, 233 K); card vs CPU max rel "
          f"{rel:.3e}", flush=True)

    # the replay at scale: J random compositions of the paper grid
    rng = np.random.default_rng(seed)
    big_idx = rng.integers(0, len(ptable), (SIM_J, SIM_S)).astype(np.int32)
    big_idx[rng.random((SIM_J, SIM_S)) < 0.01] = -1
    big_task = TaskReq("big", "big", {
        "L1": LevelReq("L1", 1 << 20, (Bucket(0.6, 1.2e9, 2e-6),
                                       Bucket(0.4, 5e8, 1e-4))),
        "L2": LevelReq("L2", 64 << 20, (Bucket(0.5, 1e9, 1e-3),
                                        Bucket(0.5, 2e9, 3e-6)))})
    big_traces = sim.task_traces(big_task,
                                 ("prefill", "decode", "train_step"))
    cols = sim_cols(ptable)
    big_walls = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        big = sim.simulate_traces(cols, big_idx, big_traces,
                                  policy=boost_policy, device="cuda")
        torch.cuda.synchronize()
        big_walls.append(time.perf_counter() - t0)
    t0 = time.perf_counter()
    big_cpu = sim.simulate_traces(cols, big_idx, big_traces,
                                  policy=boost_policy, device="cpu")
    big_cpu_s = time.perf_counter() - t0
    rel = sim_gap(big, big_cpu)
    n_bad = int(np.any(big_idx < 0, axis=1).sum())
    if rel > RTOL_SIM or not np.isinf(big["e_total_j"]).sum() == n_bad:
        fail(f"simulate_traces J={SIM_J} on the card: max rel {rel:.3e} "
             f"(gate {RTOL_SIM}), {n_bad} sentinel rows")
    sim_stats["grid"] = {"J": SIM_J, "S": SIM_S, "phases": 3,
                         "first_s": big_walls[0], "warm_s": big_walls[1],
                         "cpu_s": big_cpu_s, "max_rel_vs_cpu": rel,
                         "sentinel_rows": n_bad}
    print(f"simulate: simulate_traces J={SIM_J} x S={SIM_S} x 3 phases "
          f"({n_bad} sentinel rows), card vs CPU max rel {rel:.3e}; card "
          f"{big_walls[0]:.4f} s first, {big_walls[1]:.4f} s warm, CPU "
          f"{big_cpu_s:.4f} s", flush=True)

    # a cached repeat: no replay, no characterization, no retention launch
    with tempfile.TemporaryDirectory() as cache_dir:
        api.simulate(task=gainsight.TASKS[1], cache=cache_dir, device="cuda")
        kretention.retention_batch.launches = 0
        counts = (sim.sim_eval_count(), api.characterize_call_count())
        hit = api.simulate(task=gainsight.TASKS[1], cache=cache_dir,
                           device="cuda")
        if (sim.sim_eval_count(), api.characterize_call_count()) != counts \
                or kretention.retention_batch.launches != 0 \
                or hit.refined != "simulate":
            fail("a cached simulate re-ran the replay, the "
                 "characterization or the retention kernel")
    print("simulate: a cached repeat ran no replay, no characterization and "
          "no retention launch", flush=True)
    for key, label, fn in (
            ("profile", "warm simulate (task 1, table built)",
             lambda: api.simulate(ptable, gainsight.TASKS[0],
                                  device="cuda")),
            ("grid_profile", f"warm simulate_traces J={SIM_J}",
             lambda: sim.simulate_traces(cols, big_idx, big_traces,
                                         policy=boost_policy,
                                         device="cuda"))):
        prof = profile_report(label, fn)
        sim_stats[key] = {k: prof[k] for k in
                          ("wall_s", "device_ms", "launches")}
    return sim_stats, sim_launches


def facade_phase():
    """Phase 17: ``Compiler.compile``, ``Macro.write_all`` and
    ``Compiler.gradient_size`` on the card against the CPU. Returns (stats,
    retention launches of one ``compile``)."""
    import tempfile

    import torch
    from repro_torch import api
    from repro_torch.kernels import retention as kretention
    kretention.retention_batch.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    macro = api.Compiler(device="cuda").compile(**FACADE_MACRO)
    compile_s = time.perf_counter() - t0
    compile_launches = kretention.retention_batch.launches
    cpu_macro = api.Compiler(device="cpu").compile(**FACADE_MACRO)
    ppa_rel = max(abs(macro.ppa[k] - v) / max(abs(v), 1e-300)
                  for k, v in cpu_macro.ppa.items())
    if compile_launches != 1 or ppa_rel > RTOL_CPU:
        fail(f"Compiler().compile on the card: {compile_launches} retention "
             f"launches (expected 1), PPA max rel {ppa_rel:.3e} vs the CPU")
    with tempfile.TemporaryDirectory() as out:
        out = Path(out)
        rep = macro.write_all(out / "card")
        api.Macro(config=macro.config, ppa=cpu_macro.ppa).write_all(
            out / "card_cpu_ppa")
        cpu_macro.write_all(out / "cpu")
        name = macro.name
        same = {ext: (out / "card" / f"{name}.{ext}").read_bytes()
                == (out / "cpu" / f"{name}.{ext}").read_bytes()
                for ext in ("sp", "lef")}
        same.update({ext: (out / "card_cpu_ppa" / f"{name}.{ext}")
                     .read_bytes() == (out / "cpu" / f"{name}.{ext}")
                     .read_bytes() for ext in ("v", "lib")})
    if not all(same.values()) or not rep["drc_clean"] or \
            not rep["lvs_clean"]:
        fail(f"Macro.write_all on the card: byte-equal {same}, DRC "
             f"{rep['drc_errors'][:3]}, LVS {rep['lvs_errors'][:3]}")
    cfg = api.MacroConfig(**FACADE_MACRO)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sized = api.Compiler(device="cuda").gradient_size(cfg)
    torch.cuda.synchronize()
    grad_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu_sized = api.Compiler(device="cpu").gradient_size(cfg)
    grad_cpu_s = time.perf_counter() - t0
    grad_rel = max(abs(sized[k] - v) / abs(v) for k, v in cpu_sized.items())
    if grad_rel > RTOL_GRAD or not sized["speedup"] > 1.0:
        fail(f"gradient_size on the card: max rel {grad_rel:.3e} vs the CPU "
             f"(gate {RTOL_GRAD}), speedup {sized['speedup']:.3f}")
    prof = profile_report("warm gradient_size", lambda: api.Compiler(
        device="cuda").gradient_size(cfg))
    facade = {"compile_launches": compile_launches, "compile_s": compile_s,
              "ppa_max_rel_vs_cpu": ppa_rel, "byte_equal": same,
              "drc_clean": True, "lvs_clean": True,
              "gradient_size_s": grad_s, "gradient_size_cpu_s": grad_cpu_s,
              "gradient_profile": {k: prof[k] for k in
                                   ("wall_s", "device_ms", "launches")},
              "gradient_max_rel_vs_cpu": grad_rel,
              "speedup": sized["speedup"]}
    print(f"facade: Compiler().compile({macro.name}) on the card: "
          f"{compile_launches} retention launch, {compile_s:.4f} s, PPA max "
          f"rel {ppa_rel:.3e} vs the CPU; write_all .sp .lef byte-equal to "
          f"the CPU's, .v .lib byte-equal given its PPA, DRC and LVS clean; "
          f"gradient_size {grad_s:.4f} s first (the CPU {grad_cpu_s:.4f} s), "
          f"speedup {sized['speedup']:.4f}, max rel {grad_rel:.3e} vs the "
          f"CPU", flush=True)
    return facade, compile_launches


def warm_pair(fn, rounds: int = 2):
    """Warm wall seconds of ``fn(False)`` and ``fn(True)`` (the switch off
    and on), taken in turns (off, on, on, off, ...) with a synchronize
    around each call; returns (off seconds, on seconds, last off output,
    last on output), each time the least of its ``rounds`` calls."""
    import torch
    times, outs = {False: [], True: []}, {}
    for i in range(rounds):
        for on in ((False, True) if i % 2 == 0 else (True, False)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            outs[on] = fn(on)
            torch.cuda.synchronize()
            times[on].append(time.perf_counter() - t0)
    return min(times[False]), min(times[True]), outs[False], outs[True]


def same_report(a, b) -> bool:
    """Two composition reports with the same compositions, in the same
    order, and bit-equal metrics (the re-rank's ``sim_*`` keys included)."""
    from repro_torch.sim.rerank import composition_idx
    return (a.labels() == b.labels()
            and composition_idx(a).tolist() == composition_idx(b).tolist()
            and [c.metrics for c in a.ranked] == [c.metrics for c in b.ranked])


def same_explore(a, b) -> bool:
    import numpy as np
    return (a.labels() == b.labels()
            and picks_of(a.selections) == picks_of(b.selections)
            and a.table.metric_names == b.table.metric_names
            and all(np.array_equal(a.table[k], b.table[k])
                    for k in a.table.metric_names))


def observability_phase(ptable, cfg, params, prompt, launches_by_path,
                        seed: int):
    """Phase 18: telemetry, the sanitizer and the device grid on the card
    (see the module docstring). Returns the phase's stats."""
    import tempfile

    import numpy as np
    import torch
    from repro_torch import api, hetero, obs
    from repro_torch.analysis import sanitize
    from repro_torch.core import corners as corners_mod
    from repro_torch.core import gainsight
    from repro_torch.hetero import system
    from repro_torch.kernels import flash_attention as kflash
    from repro_torch.kernels import retention as kretention
    from repro_torch.kernels import ssm_scan as kssm
    from repro_torch.obs import catalog, report
    from repro_torch.serve.engine import Engine

    swept = hetero.ComposePolicy(vdd_sweep=(VDD_SWEEP_POINT,))
    power_bb = hetero.ComposePolicy(**NLEVEL_POLICIES["power_bb"])
    task = gainsight.TASKS[0]
    # path -> (call with a Compiler, the launches_by_path key of its
    # retention launches, how its outputs compare)
    calls = {
        "explore": (lambda c: c.explore(), "explore", same_explore),
        "compose_vdd_sweep": (lambda c: c.compose(
            task, space=ptable, compose_policy=swept), "compose_vdd_sweep",
            same_report),
        "compose_power_bb": (lambda c: c.compose(
            gainsight.nlevel_task(3), space=ptable, compose_policy=power_bb),
            None, same_report),
        "simulate": (lambda c: c.simulate(task), "simulate", same_report),
    }
    stats = {"telemetry": {}, "sanitizer": {}, "grid": {}}

    # telemetry: every call once traced, counting its retention launches
    obs.disable()
    obs.clear()
    dispatch = "kernels.dispatch.retention.cuda"
    traced_outs, spans_per_call = {}, {}
    for path, (call, key, _) in calls.items():
        kretention.retention_batch.launches = 0
        n0, e0 = obs.value(dispatch), len(obs.events())
        traced_outs[path] = call(api.Compiler(device="cuda", telemetry=True))
        spans_per_call[path] = len(obs.events()) - e0
        got = (obs.value(dispatch) - n0, kretention.retention_batch.launches)
        want = launches_by_path[key] if key else 0
        if got != (want, want) or obs.enabled():
            fail(f"telemetry {path}: {dispatch} moved {got[0]}, the "
                 f"wrapper counted {got[1]} retention launches, the "
                 f"profiled phases {want}; tracing left on {obs.enabled()}")
    engine = Engine(cfg, params, max_seq=SERVE_MAX_SEQ, device="cuda")
    steps = 8
    n_kernels = {op: obs.value(f"kernels.dispatch.{op}.cuda")
                 for op in ("flash_attention", "ssm_scan")}
    kflash.flash_attention.launches = kssm.ssm_scan.launches = 0
    with obs.enabled_scope(True):
        traced_tokens = engine.generate({"tokens": prompt}, steps=steps)
    got = {op: (obs.value(f"kernels.dispatch.{op}.cuda") - n_kernels[op])
           for op in n_kernels}
    if got != {"flash_attention": kflash.flash_attention.launches,
               "ssm_scan": kssm.ssm_scan.launches} \
            or set(got.values()) != {cfg.num_layers}:
        fail(f"traced generate: kernel dispatches {got}, wrapper launches "
             f"{kflash.flash_attention.launches} / {kssm.ssm_scan.launches},"
             f" expected {cfg.num_layers} each")
    events, snap = obs.events(), obs.snapshot()
    names = [e["name"] for e in events]
    want_serve = {"serve.prefill": 1, "serve.sample": steps,
                  "serve.decode_step": steps}
    if {n: names.count(n) for n in want_serve} != want_serve:
        fail(f"traced generate: serve spans "
             f"{ {n: names.count(n) for n in want_serve} }")
    uncovered = sorted({n for n in names if not catalog.covers(n)}
                       | {n for sec in ("counters", "gauges", "histograms")
                          for n in snap[sec] if not catalog.covers(n)})
    if uncovered:
        fail(f"names the catalog does not cover: {uncovered}")
    with tempfile.TemporaryDirectory() as tmp:
        path = obs.write(Path(tmp) / "trace.json")
        doc = json.loads(Path(path).read_text())
        n_x = sum(e["ph"] == "X" for e in doc["traceEvents"])
        print(f"telemetry: Chrome trace {n_x} spans, "
              f"{len(doc['traceEvents']) - n_x} counters, "
              f"{Path(path).stat().st_size} bytes; the report:")
        print(report.render_file(path), flush=True)
    obs.clear()

    # the same calls with telemetry off and on: bit-equal, warm wall time
    for path, (call, _, same) in calls.items():
        off_s, on_s, off, on = warm_pair(lambda t: call(api.Compiler(
            device="cuda", telemetry=t)))
        if not (same(off, on) and same(off, traced_outs[path])):
            fail(f"telemetry {path}: outputs differ with telemetry on")
        stats["telemetry"][path] = {"off_s": off_s, "on_s": on_s}
        print(f"telemetry: {path} warm {off_s:.4f} s off, {on_s:.4f} s on, "
              f"outputs bit-equal", flush=True)
    obs.clear()

    def gen(on):
        with obs.enabled_scope(on):
            return engine.generate({"tokens": prompt}, steps=steps)
    off_s, on_s, off, on = warm_pair(gen)
    if not (np.array_equal(off, on) and np.array_equal(off, traced_tokens)):
        fail("telemetry: generate tokens differ with telemetry on")
    stats["telemetry"]["generate"] = {"off_s": off_s, "on_s": on_s,
                                      "steps": steps}
    print(f"telemetry: generate ({SERVE_REQUESTS} x {SERVE_PROMPT} tokens, "
          f"{steps} steps) warm {off_s:.4f} s off, {on_s:.4f} s on, tokens "
          f"equal; the flash-attention and scan kernels {cfg.num_layers} "
          f"launches each", flush=True)
    obs.clear()
    prof = {on: profile_report(f"warm explore, telemetry {on}",
                               lambda on=on: api.Compiler(
                                   device="cuda", telemetry=on).explore())
            for on in (False, True)}
    obs.clear()
    if prof[False]["host_calls"] != prof[True]["host_calls"]:
        fail(f"telemetry adds launches: {prof[False]['host_calls']} launch "
             f"and copy calls off, {prof[True]['host_calls']} on (device "
             f"records {prof[False]['launches']}, {prof[True]['launches']})")
    stats["telemetry"]["profiled_launches"] = prof[False]["launches"]
    stats["telemetry"]["host_launch_calls"] = prof[False]["host_calls"]
    # the off path's host cost: what a disabled span and an unset sanitizer
    # switch cost per use, times the spans a call records when traced
    n = 100_000
    t0 = time.perf_counter()
    for _ in range(n):
        with obs.span("t.off", probe=None, J=1):
            pass
    span_ns = (time.perf_counter() - t0) / n * 1e9
    t0 = time.perf_counter()
    for _ in range(n):
        sanitize.maybe_wrap(len)
    wrap_ns = (time.perf_counter() - t0) / n * 1e9
    stats["telemetry"]["off_path"] = {"span_ns": span_ns, "wrap_ns": wrap_ns,
                                      "spans_per_call": spans_per_call}
    print(f"telemetry: off path on this host: a disabled span {span_ns:.0f} "
          f"ns, an unset sanitizer switch {wrap_ns:.0f} ns; spans a call "
          f"{spans_per_call} (at most "
          f"{max(spans_per_call.values()) * (span_ns + wrap_ns) / 1e3:.1f} "
          f"us a call)", flush=True)

    # the sanitizer: the wired calls clean and bit-equal, its warm cost
    for path in ("explore", "compose_vdd_sweep", "simulate"):
        call, _, same = calls[path]
        off_s, on_s, off, on = warm_pair(lambda s: call(api.Compiler(
            device="cuda", sanitize=s)))
        if not (same(off, on) and same(off, traced_outs[path])):
            fail(f"sanitizer {path}: outputs differ when sanitized")
        stats["sanitizer"][path] = {"off_s": off_s, "on_s": on_s}
        print(f"sanitizer: {path} clean, outputs bit-equal; warm {off_s:.4f}"
              f" s off, {on_s:.4f} s on ({on_s / off_s:.1f}x)", flush=True)
    dev = torch.device("cuda", 0)
    try:
        sanitize.wrap(torch.log)(-torch.ones(4, device=dev))
        fail("sanitizer: torch.log of a negative tensor did not raise")
    except FloatingPointError as e:
        if "aten.log" not in str(e):
            fail(f"sanitizer: the NaN error does not name the op: {e}")
        print(f"sanitizer: cuda:0 {type(e).__name__}: {e}")
    try:
        sanitize.wrap(torch.gather)(torch.arange(8.0, device=dev), 0,
                                    torch.tensor([3, 8], device=dev))
        fail("sanitizer: an out-of-range gather did not raise")
    except IndexError as e:
        print(f"sanitizer: cuda:0 {type(e).__name__}: {e}")
    # the context survived: the card goes on launching and syncing
    explored = api.explore(ptable, device="cuda")
    torch.cuda.synchronize()
    if not same_explore(explored, traced_outs["explore"]):
        fail("sanitizer: explore after the index error differs")
    print("sanitizer: after the out-of-range gather the card goes on: "
          "explore on the table equal to the traced one", flush=True)

    # the grid: J random compositions x S slots x the 4 named corners
    named = tuple(corners_mod.CORNERS)
    ctable = api.DesignTable.build(corners=named, device="cuda")
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, len(ptable), (SIM_J, SIM_S)).astype(np.int32)
    idx[rng.random((SIM_J, SIM_S)) < 0.01] = -1
    cap_bits = [2.0e5, 1.0e6, 3.2e7, 6.4e7]
    f_req = [1.2e9, 5.0e8, 1.0e9, 2.0e9]
    per_corner = [ctable.corner_metrics(c) for c in ctable.corner_labels]
    for label, score, first in (
            ("score_grid", system.score_grid, ptable.metrics),
            ("score_grid_corners", system.score_grid_corners, per_corner)):
        def run(devices, k=1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = score(first, idx, cap_bits, f_req, sharded=k > 1,
                        devices=devices, device="cuda")
            return out, time.perf_counter() - t0
        score(first, idx, cap_bits, f_req, device="cuda")       # warm
        plain, plain_s = run(None)
        row = {"plain_s": plain_s}
        for k in (2, 4):
            n0 = obs.value("parallel.shard_calls")
            run([dev] * k, k)                                    # warm
            got, s = run([dev] * k, k)
            bad = [m for m in system.SYSTEM_METRICS
                   if not np.array_equal(got[m], plain[m])]
            if bad or obs.value("parallel.shard_calls") != n0 + 2:
                fail(f"{label} sharded over [cuda:0] x {k}: metrics {bad} "
                     f"differ from the plain call, shard calls "
                     f"{obs.value('parallel.shard_calls') - n0}")
            row[f"k{k}_s"] = s
        stats["grid"][label] = row
        print(f"grid: {label} J={SIM_J} x S={SIM_S}"
              + (f" x {len(named)} corners" if first is per_corner else "")
              + f": sharded over [cuda:0] x 2 and x 4 bit-equal to the "
              f"plain call; warm {row['plain_s']:.4f} s plain, "
              f"{row['k2_s']:.4f} s x 2, {row['k4_s']:.4f} s x 4",
              flush=True)
    for label, kw in (("TASKS[0]", dict(task=task)),
                      ("nlevel3 power_bb", dict(
                          task=gainsight.nlevel_task(3),
                          compose_policy=power_bb))):
        n0 = obs.value("parallel.shard_calls")
        plain = hetero.compose(ptable, device="cuda", **kw)
        sharded = hetero.compose(ptable, sharded=True, device="cuda", **kw)
        if not same_report(plain, sharded) or \
                obs.value("parallel.shard_calls") != n0:
            fail(f"compose(sharded=True) on one card, {label}: not the "
                 f"plain call")
    print("grid: compose(sharded=True) on the one card is the plain call, "
          "reports equal", flush=True)
    return stats


def attn_bwd_bound(B, H, K, S, D, itemsize, window=None, sink=0, Dv=None):
    """(bound ms, 'bytes' | 'operations') of the attention backward, q/k
    head dim D and value head dim Dv (D unless given), counting only the
    scores the mask leaves."""
    Dv = D if Dv is None else Dv
    scores = B * H * visible_scores(S, window, sink)
    t_mm = scores * (ATTN_BWD_FLOPS_PER_SCORE_D * D
                     + ATTN_BWD_FLOPS_PER_SCORE_DV * Dv) / PEAK_BF16_TC
    t_elem = (scores * ATTN_ELEM_OPS_PER_SCORE + 2 * B * H * S * Dv) \
        / PEAK_FP32_OPS
    t_bytes = (2 * (B * H * S + B * K * S) * (D + Dv) * itemsize
               + 4 * B * H * S) / PEAK_BYTES
    t_ops = max(t_mm, t_elem)
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def attn_bwd_stage_bounds(B, H, K, S, D, Dv, itemsize, window=None,
                          sink=0, partials=False):
    """{stage of ``ATTN_BWD_KERNELS``: (bound ms, 'bytes' | 'operations')}
    of a bf16 attention backward launch (self-attention, Sk = S), each
    stage with its own products and bytes as the launch splits the work:
    delta reads o and dO and writes Delta; dK/dV does S, dP, dV and dK (4 D
    + 4 Dv flops a visible score) and reads q, k, v, dO, lse and Delta; dQ
    + combine recomputes S and dP beside dQ (4 D + 2 Dv), reads the same
    and writes dq. With ``partials`` (a dK/dV block a query head: every
    pair but the two-warpgroup one, and that one where
    ``kflash.backward_heads_per_block`` is 1 < H / K) dK/dV writes the fp32
    partials of every query head, which the combine reads to write dk and
    dv; else dK/dV writes dk and dv itself. The dQ pass's recomputation
    makes the stages' bounds sum to more than the launch's
    (``attn_bwd_bound``)."""
    scores = B * H * visible_scores(S, window, sink)
    rows = B * H * S
    inputs = (rows + B * K * S) * (D + Dv) * itemsize + 8 * rows
    dkdv = B * K * S * (D + Dv) * itemsize
    partials = 4 * rows * (D + Dv) if partials else 0

    def one(flops, elem_ops, nbytes):
        t_ops = max(flops / PEAK_BF16_TC, elem_ops / PEAK_FP32_OPS)
        t_bytes = nbytes / PEAK_BYTES
        return (max(t_ops, t_bytes) * 1e3,
                "operations" if t_ops >= t_bytes else "bytes")
    elem = scores * ATTN_ELEM_OPS_PER_SCORE
    return {"delta": one(0, 2 * rows * Dv, 2 * rows * Dv * itemsize
                         + 4 * rows),
            "dkdv": one(scores * 4 * (D + Dv), elem,
                        inputs + (partials or dkdv)),
            "dq+combine": one(scores * (4 * D + 2 * Dv), elem,
                              inputs + rows * D * itemsize
                              + (partials + dkdv if partials else 0))}


def ptxas_kernels(log: str) -> dict:
    """{mangled entry name: {"registers", "spill_stores", "spill_loads"}}
    of each kernel in an ``nvcc -Xptxas -v`` report."""
    import re
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1)
            out[name] = {}
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            out[name].update(spill_stores=int(m[1]), spill_loads=int(m[2]))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[name]["registers"] = int(m[1])
    return out


def bwd_kernels(D: int, Dv: int):
    """(route, {kernel: ptxas report}, ptxas's wgmma notes) of the bf16
    attention backward at (D, Dv), from the build's report kept beside the
    library: its dK/dV and dQ kernels' registers and spills, and the route
    their names give (``_wg``: wgmma, ``_tc``: mma.sync)."""
    import re
    from repro_torch.kernels import build
    log = build.build_library("flash_attention_bwd").with_suffix(
        ".log").read_text()
    tag = f"ILi{D}ELi{Dv}E"
    kernels = {}
    for name, rep in ptxas_kernels(log).items():
        m = re.search(rf"((?:dkdv|dq)_kernel_\w+?){tag}", name)
        if m and not m[1].endswith("_f32"):
            kernels[f"{m[1]}<{D}, {Dv}>"] = rep
    routes = {"wgmma" if "_wg" in n else "mma.sync" for n in kernels}
    notes = [line.strip() for line in log.splitlines()
             if "wgmma" in line and tag in line]
    return " + ".join(sorted(routes)), kernels, notes


def mla_backward_profile(seed: int) -> dict:
    """The bf16 attention backward at deepseek-v3's training shape
    (``MLA_BWD_CASES[0]``): its time (``median_ms``) beside its bound, its
    three kernels' device times (``kernel_split_ms``) each beside its own
    bound (``attn_bwd_stage_bounds``), and its dK/dV and dQ kernels' route,
    registers and spills (``bwd_kernels``); printed and returned."""
    import numpy as np
    import torch
    from repro_torch.kernels import flash_attention as kflash
    B, H, K, S, D, Dv, _ = MLA_BWD_CASES[0]
    dev = torch.device("cuda")
    q, k, v = attn_inputs((B, H, K, S, D, Dv), torch.bfloat16, seed, dev)
    do = torch.from_numpy(np.random.default_rng(seed + 1).normal(
        size=(B, H, S, Dv)).astype(np.float32)).to(dev, torch.bfloat16)
    o, lse = kflash._forward(q, k, v, True, None, 0, False, with_lse=True)

    def bwd():
        return kflash.flash_attention_bwd(q, k, v, o, do, lse)
    ms = median_ms(bwd)
    stages_ms = kernel_split_ms(bwd, ATTN_BWD_KERNELS)
    stage_bounds = attn_bwd_stage_bounds(B, H, K, S, D, Dv, 2)
    b_ms, b_by = attn_bwd_bound(B, H, K, S, D, 2, Dv=Dv)
    route, kernels, notes = bwd_kernels(192, 128)
    label = f"flash_attention_bwd MLA {(B, H, K, S, D, Dv)} bf16"
    print(f"stages {label}: kernel {ms:.4f} ms (bound {b_ms:.4f}, {b_by}); "
          "on the device: " + ", ".join(
              f"{n} {fmt_ms(t)} ms (bound {stage_bounds[n][0]:.4f}, "
              f"{stage_bounds[n][1]})" for n, t in stages_ms.items()),
          flush=True)
    print(f"route {label}: {route}; " + "; ".join(
        f"{n} {r.get('registers')} registers, {r.get('spill_stores')} B "
        f"of spill stores, {r.get('spill_loads')} B of spill loads"
        for n, r in sorted(kernels.items())), flush=True)
    for line in notes:
        print(f"ptxas: {line}", flush=True)
    del q, k, v, do, o, lse
    torch.cuda.empty_cache()
    return {"ms": ms, "stages_ms": stages_ms,
            "stage_bounds": {n: {"ms": t, "by": by}
                             for n, (t, by) in stage_bounds.items()},
            "route": route, "registers": kernels, "ptxas_notes": notes}


def ssm_bwd_bound(B, S, di, n, n_states):
    """``least_time`` of the selective-scan backward, float32."""
    ops = B * S * di * (SSM_BWD_OPS_PER_STATE * n + SSM_BWD_OPS_PER_CHANNEL)
    nbytes = 4 * (5 * B * S * di + 4 * B * S * n + 2 * (di * n + di)
                  + B * n_states * di * n)
    return least_time(nbytes, ops, B * S * di * n)


# the kernels of each backward launch, by a piece of their names as
# torch.profiler gives them (the attention's combine runs in dQ's launch)
ATTN_BWD_KERNELS = {"delta": "delta_kernel", "dkdv": "dkdv_kernel",
                    "dq+combine": "dq_kernel"}
SSM_BWD_KERNELS = {name: f"ssm_scan_bwd_{name}" for name in (
    "chunk_adjoint", "carries", "grads", "reduce")}


def kernel_split_ms(fn, kernels) -> dict:
    """{name: device ms a call, or None} of each of ``kernels`` ({name: a
    piece of the kernel's name}): ``fn`` run ``SPLIT_CALLS`` times, after
    one warm call, under one ``torch.profiler`` window: each kernel's device
    time over the records the trace holds of it. A window whose trace holds
    no record of a kernel is run again, up to ``SPLIT_WINDOWS`` in all; a
    kernel no window recorded is None (not measured), and said so."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    out = {}
    for window in range(1, SPLIT_WINDOWS + 1):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(SPLIT_CALLS):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA]
        for name, piece in kernels.items():
            hits = [e for e in events if piece in e.key]
            records = sum(e.count for e in hits)
            if name not in out and records:
                out[name] = sum(e.self_device_time_total for e in hits) \
                    / records / 1e3
        missing = [name for name in kernels if name not in out]
        if not missing:
            break
        print(f"profiler: window {window} of {SPLIT_WINDOWS} holds no device "
              f"record of {missing} in {SPLIT_CALLS} calls", flush=True)
    return {name: out.get(name) for name in kernels}


def fmt_ms(t) -> str:
    return "not measured" if t is None else f"{t:.4f}"


def device_share(part_ms, whole_ms) -> str:
    """``part_ms`` as a percentage of ``whole_ms``; "not measured" when the
    trace held no device time."""
    if not whole_ms:
        return "not measured"
    return f"{100 * part_ms / whole_ms:.2f} %"


def median_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """The median of ``TIME_REPEATS`` queued readings of ``time_ms``."""
    return sorted(time_ms(fn, iters, warmup, queued=True)
                  for _ in range(TIME_REPEATS))[TIME_REPEATS // 2]


def same_twice(label, fn):
    """Run ``fn`` (a tuple of tensors) twice; fail unless bit-equal."""
    import torch
    first, second = fn(), fn()
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(first, second)):
        fail(f"{label}: two runs of the backward differ")
    print(f"determinism {label}: two runs bit-equal", flush=True)


def sdpa_backward_ms(leaves, do, required: bool = True):
    """(backend name, median ms) of SDPA's backward (causal, GQA) on the
    first of ``SDPA_BACKENDS`` that runs; where none does, fails, or
    returns (None, None) unless ``required``."""
    import torch
    from torch.nn.attention import SDPBackend, sdpa_kernel
    for name in SDPA_BACKENDS:
        backend = getattr(SDPBackend, name)
        try:
            with sdpa_kernel([backend]):
                o = torch.nn.functional.scaled_dot_product_attention(
                    *leaves, is_causal=True, enable_gqa=True)
                return name, median_ms(lambda: torch.autograd.grad(
                    o, leaves, do, retain_graph=True))
        except RuntimeError as err:
            print(f"SDPA backend {name} does not run here: "
                  f"{str(err).splitlines()[0]}", flush=True)
    if required:
        fail(f"none of the SDPA backends {SDPA_BACKENDS} runs")
    return None, None


def rel_gaps(got, want):
    """max|got - want| / max|want| of each pair."""
    return [((g.float() - w.float()).abs().max()
             / w.float().abs().max()).item() for g, w in zip(got, want)]


def abs_err(got, want) -> float:
    """The largest max|got - want| over the pairs."""
    return max((g.float() - w.float()).abs().max().item()
               for g, w in zip(got, want))


def mla_backward_checks(seed: int):
    """Phase 19's MLA part: the attention backward at ``MLA_BWD_CASES``
    against ``ref.attention_ref_grads`` (one launch a backward, phase 19's
    gates), bit-equal twice at the training shape, and the bf16 training
    shape's time beside its bound, the plain backward's and SDPA's where a
    backend of it takes Dv != D, then ``mla_backward_profile``; fails
    unless its dK/dV and dQ kernels run on wgmma without spill stores.
    Returns its stats."""
    import numpy as np
    import torch
    from repro_torch.kernels import flash_attention as kflash
    from repro_torch.kernels import ref
    dev = torch.device("cuda")
    out = {"max_rel_err": {}, "cases": []}
    for i, (B, H, K, S, D, Dv, dtype) in enumerate(MLA_BWD_CASES):
        dt = getattr(torch, dtype)
        q, k, v = attn_inputs((B, H, K, S, D, Dv), dt, seed, dev)
        do = torch.from_numpy(np.random.default_rng(seed + 1).normal(
            size=(B, H, S, Dv)).astype(np.float32)).to(dev, dt)
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]

        def bwd():
            o = kflash.flash_attention(*leaves, round_p=False)
            return torch.autograd.grad(o, leaves, do)
        n0 = kflash.flash_attention_bwd.launches
        wg0 = kflash.flash_attention.wg_launches
        got = bwd()
        want = ref.attention_ref_grads(q, k, v, do)
        torch.cuda.synchronize()
        if kflash.flash_attention_bwd.launches != n0 + 1:
            fail("the MLA attention backward did not launch its kernel once")
        wg = int(kflash.forward_kernel(D, Dv, dt) == "flash_kernel_wg")
        if kflash.flash_attention.wg_launches - wg0 != wg:
            fail(f"the MLA attention forward ({B, H, K, S, D, Dv, dtype}) did "
                 f"not launch flash_kernel_wg {wg} times")
        gaps = rel_gaps(got, want)
        gate = RTOL_ATTN_BWD[dtype]
        label = f"flash_attention_bwd MLA {(B, H, K, S, D, Dv)} {dtype}"
        print(f"kernel {label}: max|kernel - plain| / max|plain| dq "
              f"{gaps[0]:.3e}, dk {gaps[1]:.3e}, dv {gaps[2]:.3e} (gate "
              f"{gate})", flush=True)
        if max(gaps) > gate or not all(torch.isfinite(g).all() for g in got) \
                or [tuple(g.shape) for g in got] != \
                [tuple(t.shape) for t in (q, k, v)]:
            fail(f"{label}: gradients {gaps} beyond {gate}")
        out["max_rel_err"][dtype] = max(out["max_rel_err"].get(dtype, 0.0),
                                        *gaps)
        out["cases"].append({"case": [B, H, K, S, D, Dv, dtype],
                             "gaps": gaps, "max_abs_err": abs_err(got, want)})
        del got, want
        if i < 2:
            same_twice(label, bwd)
        if i == 0:
            o, lse = kflash._forward(q, k, v, True, None, 0, False,
                                     with_lse=True)
            ms = median_ms(lambda: kflash.flash_attention_bwd(
                q, k, v, o, do, lse))
            o_plain = ref.attention_ref(*leaves, round_p=False)
            plain_ms = time_ms(lambda: torch.autograd.grad(
                o_plain, leaves, do, retain_graph=True), 3, 1)
            del o_plain
            backend, lib_ms = sdpa_backward_ms(leaves, do, required=False)
            b_ms, b_by = attn_bwd_bound(B, H, K, S, D, 2, Dv=Dv)
            out.update({"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                        "library": None if backend is None else
                        f"SDPA backward, {backend}",
                        "bound_ms": b_ms, "bound_by": b_by,
                        "shape": [B, H, K, S, D, Dv]})
            print(f"timing {label}: kernel {ms:.4f} ms, plain "
                  f"{plain_ms:.4f} ms, "
                  + (f"SDPA backward on {backend} {lib_ms:.4f} ms"
                     if backend else "no SDPA backend takes Dv != D")
                  + f", bound {b_ms:.4f} ms ({b_by})", flush=True)
            del o, lse
        del leaves
    torch.cuda.empty_cache()
    out["profile"] = mla_backward_profile(seed)
    spilled = {n: r for n, r in out["profile"]["registers"].items()
               if r.get("spill_stores", 0) > 0}
    if out["profile"]["route"] != "wgmma" or spilled:
        fail(f"the bf16 attention backward at (192, 128) runs on "
             f"{out['profile']['route']}, spills {spilled}: want wgmma, no "
             f"spill stores")
    return out


def backward_kernels_phase(seed: int):
    """Phase 19: each backward kernel through its autograd wrapper against
    autograd of its plain version (see the module docstring), and its time
    beside its bound, the plain backward's and (attention) SDPA's
    backward's. Returns {name: stats}."""
    import torch
    from repro_torch.kernels import flash_attention as kflash
    from repro_torch.kernels import ref
    from repro_torch.kernels import ssm_scan as kssm
    dev = torch.device("cuda")
    out = {"flash_attention_bwd": {"max_rel_err": {}, "cases": []},
           "ssm_scan_bwd": {"max_rel_err": 0.0, "cases": []}}
    for B, H, K, S, D, window, sink, dtype in ATTN_BWD_CASES:
        q, k, v = attn_inputs((B, H, K, S, D), getattr(torch, dtype), seed,
                              dev)
        do = attn_inputs((B, H, K, S, D), getattr(torch, dtype), seed + 1,
                         dev)[0]
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        n0 = kflash.flash_attention_bwd.launches
        o = kflash.flash_attention(*leaves, window=window, sink=sink,
                                   round_p=False)
        got = torch.autograd.grad(o, leaves, do)
        want = ref.attention_ref_grads(q, k, v, do, window=window, sink=sink)
        torch.cuda.synchronize()
        if kflash.flash_attention_bwd.launches != n0 + 1:
            fail("the attention backward did not launch its kernel once")
        gaps = rel_gaps(got, want)
        gate = RTOL_ATTN_BWD[dtype]
        label = (f"flash_attention_bwd {(B, H, K, S, D)} {dtype} window="
                 f"{window} sink={sink}")
        print(f"kernel {label}: max|kernel - plain| / max|plain| dq "
              f"{gaps[0]:.3e}, dk {gaps[1]:.3e}, dv {gaps[2]:.3e} (gate "
              f"{gate})", flush=True)
        if max(gaps) > gate or not all(torch.isfinite(g).all() for g in got):
            fail(f"{label}: gradients {gaps} beyond {gate}")
        err = out["flash_attention_bwd"]["max_rel_err"]
        err[dtype] = max(err.get(dtype, 0.0), *gaps)
        out["flash_attention_bwd"]["cases"].append(
            {"case": [B, H, K, S, D, window, sink, dtype], "gaps": gaps,
             "max_abs_err": abs_err(got, want)})
        del leaves, o, got, want
    out["flash_attention_bwd_mla"] = mla_backward_checks(seed)
    for shape in SSM_BWD_SHAPES:
        xs = ssm_inputs(shape, seed, dev)
        dy = ssm_inputs(shape, seed + 1, dev)[0]
        leaves = [t.clone().requires_grad_(True) for t in xs]
        n0 = kssm.ssm_scan_bwd.launches
        y, _ = kssm.ssm_scan(*leaves)
        got = torch.autograd.grad(y, leaves, dy)
        want = ref.ssm_scan_ref_grads(*xs, dy)
        torch.cuda.synchronize()
        if kssm.ssm_scan_bwd.launches != n0 + 1:
            fail("the scan backward did not launch its kernel once")
        gaps = rel_gaps(got, want)
        print(f"kernel ssm_scan_bwd {shape}: max|kernel - plain| / "
              f"max|plain| dx {gaps[0]:.3e}, ddt {gaps[1]:.3e}, dA "
              f"{gaps[2]:.3e}, dB {gaps[3]:.3e}, dC {gaps[4]:.3e}, dD "
              f"{gaps[5]:.3e} (gate {RTOL_SSM_BWD})", flush=True)
        if max(gaps) > RTOL_SSM_BWD or \
                not all(torch.isfinite(g).all() for g in got):
            fail(f"ssm_scan_bwd {shape}: gradients {gaps} beyond "
                 f"{RTOL_SSM_BWD}")
        out["ssm_scan_bwd"]["max_rel_err"] = max(
            out["ssm_scan_bwd"]["max_rel_err"], *gaps)
        out["ssm_scan_bwd"]["cases"].append({"shape": list(shape),
                                             "gaps": gaps,
                                             "max_abs_err": abs_err(got,
                                                                    want)})
        del leaves, y, got, want

    # at the training shapes: two runs bit-equal; times of the kernel alone
    # (queued and not), of its kernels on the device, of the plain backward
    # (autograd of the plain forward, the forward excluded) and of SDPA's
    for label, (B, H, K, S, D, window, sink, dtype) in zip(
            ATTN_BWD_TIMED, ATTN_BWD_CASES):
        q, k, v = attn_inputs((B, H, K, S, D), torch.bfloat16, seed, dev)
        do = attn_inputs((B, H, K, S, D), torch.bfloat16, seed + 1, dev)[0]
        o, lse = kflash._forward(q, k, v, True, window, sink, False,
                                 with_lse=True)

        def bwd():
            return kflash.flash_attention_bwd(q, k, v, o, do, lse, True,
                                              window, sink)
        same_twice(f"flash_attention_bwd {label}", bwd)
        ms = median_ms(bwd)
        unqueued_ms = time_ms(bwd, 20, 3)
        stages_ms = kernel_split_ms(bwd, ATTN_BWD_KERNELS)
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        o_plain = ref.attention_ref(*leaves, window=window, sink=sink,
                                    round_p=False)
        plain_ms = time_ms(lambda: torch.autograd.grad(
            o_plain, leaves, do, retain_graph=True), 3, 1)
        del o_plain
        backend, lib_ms = sdpa_backward_ms(leaves, do)
        b_ms, b_by = attn_bwd_bound(B, H, K, S, D, 2, window, sink)
        pair = kflash.backward_kernel(D, D, torch.bfloat16)
        nh = kflash.backward_heads_per_block(B, H, K, S, D, D,
                                             torch.bfloat16)
        partials = pair[0] != "dkdv_kernel_wg2" or nh < H // K
        stage_bounds = attn_bwd_stage_bounds(B, H, K, S, D, D, 2, window,
                                             sink, partials)
        out["flash_attention_bwd"][label] = {
            "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
            "library": f"SDPA backward, {backend}", "bound_ms": b_ms,
            "bound_by": b_by, "unqueued_ms": unqueued_ms,
            "stages_ms": stages_ms,
            "stage_bounds": {n: {"ms": t, "by": by}
                             for n, (t, by) in stage_bounds.items()},
            "kernels": list(pair), "heads_per_block": nh,
            "partials": partials}
        print(f"timing flash_attention_bwd {(B, H, K, S, D)} bf16 {label} "
              f"(window {window}, sink {sink}): kernel {ms:.4f} ms (un-"
              f"queued {unqueued_ms:.4f}; on the device: "
              + ", ".join(f"{n} {fmt_ms(t)} (bound {stage_bounds[n][0]:.4f}"
                          f", {stage_bounds[n][1]})"
                          for n, t in stages_ms.items())
              + f"), plain "
              f"{plain_ms:.4f} ms, SDPA backward on {backend} (causal, GQA; "
              f"the mask is the same at this S) {lib_ms:.4f} ms, bound "
              f"{b_ms:.4f} ms ({b_by}); {pair[0]} / {pair[1]}, "
              f"{nh} query head(s) a dK/dV block, "
              + ("fp32 partials and the combine" if partials else
                 "no partials, no combine"), flush=True)
        del leaves
    for D in (128, 96):
        route, kernels, notes = bwd_kernels(D, D)
        out["flash_attention_bwd"][f"registers_{D}"] = kernels
        out["flash_attention_bwd"][f"ptxas_notes_{D}"] = notes
        print(f"route flash_attention_bwd bf16 ({D}, {D}): {route}; "
              + "; ".join(f"{n} {r.get('registers')} registers, "
                          f"{r.get('spill_stores')} B of spill stores, "
                          f"{r.get('spill_loads')} B of spill loads"
                          for n, r in sorted(kernels.items())), flush=True)
        for line in notes:
            print(f"ptxas: {line}", flush=True)
        spilled = {n: r for n, r in kernels.items()
                   if r.get("spill_stores", 0) > 0}
        want = {f"dkdv_kernel_wg2<{D}, {D}>", f"dq_kernel_wg2<{D}, {D}>"}
        if route != "wgmma" or spilled or set(kernels) != want:
            fail(f"the bf16 attention backward at ({D}, {D}) runs "
                 f"{sorted(kernels)} on {route}, spills {spilled}: want "
                 f"{sorted(want)} on wgmma, no spill stores")
    shape = SSM_BWD_SHAPES[0]
    xs = ssm_inputs(shape, seed, dev)
    dy = ssm_inputs(shape, seed + 1, dev)[0]
    _, _, states = kssm._forward(*xs, with_states=True)

    def scan_bwd():
        return kssm.ssm_scan_bwd(*xs, states, dy)
    same_twice("ssm_scan_bwd", scan_bwd)
    ms = median_ms(scan_bwd)
    unqueued_ms = time_ms(scan_bwd, 20, 3)
    stages_ms = kernel_split_ms(scan_bwd, SSM_BWD_KERNELS)
    leaves = [t.clone().requires_grad_(True) for t in xs]
    y_plain, _ = ref.ssm_scan_ref(*leaves)
    plain_ms = time_ms(lambda: torch.autograd.grad(
        y_plain, leaves, dy, retain_graph=True), 2, 1)
    b_ms, b_by, terms = ssm_bwd_bound(*shape, states.shape[1])
    out["ssm_scan_bwd"].update({"ms": ms, "plain_ms": plain_ms,
                                "library_ms": None, "bound_ms": b_ms,
                                "bound_by": b_by, "bound_terms_ms": terms,
                                "unqueued_ms": unqueued_ms,
                                "stages_ms": stages_ms,
                                "shape": list(shape)})
    print(f"timing ssm_scan_bwd {shape}: kernel {ms:.4f} ms (un-queued "
          f"{unqueued_ms:.4f}; on the device: "
          + ", ".join(f"{n} {fmt_ms(t)}" for n, t in stages_ms.items())
          + f"), plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}; "
          f"bytes {terms['bytes']:.4f}, operations "
          f"{terms['operations']:.4f}); no single PyTorch call computes it",
          flush=True)
    del leaves, y_plain
    torch.cuda.empty_cache()
    return out


def device_gaps(prof, top: int = 3):
    """(idle ms between device kernels inside the traced window, the
    ``top`` longest idle gaps in ms) from a ``torch.profiler`` trace."""
    from torch.autograd import DeviceType
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    gaps, end = [], None
    for start, stop in spans:
        if end is not None and start > end:
            gaps.append((start - end) / 1e3)
        end = stop if end is None else max(end, stop)
    return sum(gaps), sorted(gaps, reverse=True)[:top]


def model_flops(cfg, batch: int, seq: int) -> float:
    """FLOPs of one training step of a dense-layer model (hymba, the
    dense family, phi-3-vision, or deepseek-v3 cut to its dense layers) at
    (batch, seq): 6 per matrix
    weight per token (forward and backward; the head over the text
    positions that predict; a vision model's projector over its patches),
    plus the attention's 3 x 2 (Dqk + Dv) per
    visible score per head. Remat's recomputation is not counted (model
    FLOPs)."""
    from repro_torch.models import LM, build_plan
    spec = LM(cfg, device="meta").init()
    mats = ("wq", "wk", "wv", "wo", "wg", "wu", "wi", "wd", "w_in",
            "w_dt1", "w_dt2", "w_B", "w_C", "w_out", "w_dq", "w_uq", "w_dkv",
            "w_kr", "w_uk", "w_uv")

    def count(tree):
        if isinstance(tree, dict):
            return sum(count(v) if isinstance(v, dict) else
                       (v.numel() if k in mats else 0)
                       for k, v in tree.items())
        return 0
    body = sum(count(spec[seg]) for seg in spec if isinstance(spec[seg],
                                                                dict))
    text = seq - prefix_positions(cfg)
    flops = 6 * body * batch * seq + 6 * spec["head"].numel() * batch * (
        text - 1)
    if cfg.vision:
        flops += 6 * sum(w.numel() for w in spec["vis_proj"].values()) \
            * batch * cfg.num_patches
    dqk, dv = ((cfg.qk_nope_dim + cfg.qk_rope_dim, cfg.v_head_dim)
               if cfg.mla else (cfg.head_dim, cfg.head_dim))
    for seg in build_plan(cfg):
        sink = 0 if seg.window is None else cfg.meta_tokens
        flops += len(seg.layers) * 3 * 2 * (dqk + dv) * cfg.num_heads * \
            batch * visible_scores(seq, seg.window, sink)
    return float(flops)


def prefix_positions(cfg) -> int:
    """The positions in front of the text: a vision model's patches and the
    meta tokens (``LM._prefix``)."""
    return (cfg.num_patches if cfg.vision else 0) + (cfg.meta_tokens or 0)


def training_phase(seed: int, smi: str, arch: str = "hymba-1.5b",
                   overrides=None, steps: int = TRAIN_STEPS):
    """Phase 20: full-width hymba-1.5b trained for ``TRAIN_STEPS`` steps;
    phase 33: ``TRAIN_MLA``'s cut of deepseek-v3 for ``TRAIN_MLA_STEPS``;
    phases 40 and 43: ``TRAIN_DENSE`` and ``TRAIN_VISION`` whole (see the
    module docstring). Returns its stats."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch import obs
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import SyntheticLMData
    from repro_torch.kernels import flash_attention as kflash
    from repro_torch.kernels import ssm_scan as kssm
    from repro_torch.train.step import init_train_state, make_train_step
    dev = torch.device("cuda")
    cfg = get_config(arch).replace(**(overrides or {}))
    routes = {"flash_attention": kflash.flash_attention,
              "flash_attention_bwd": kflash.flash_attention_bwd,
              "ssm_scan": kssm.ssm_scan, "ssm_scan_bwd": kssm.ssm_scan_bwd}
    plain = ("kernels.dispatch.flash_attention.plain",
             "kernels.dispatch.ssm_scan.plain")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _, step = make_train_step(cfg, base_lr=TRAIN_LR, warmup=2,
                              total_steps=steps, remat="full", device=dev)
    params, opt = init_train_state(
        cfg, torch.Generator(device=dev).manual_seed(seed), device=dev)
    n_params = sum(t.numel() for t in to_leaves(params))
    data = SyntheticLMData(cfg, TRAIN_BATCH, TRAIN_SEQ, seed)
    plain0 = [obs.value(c) for c in plain]
    for fn in routes.values():
        fn.launches = 0
    kflash.flash_attention.wg_launches = 0
    kflash.flash_attention_bwd.wg_launches = 0
    rows = []
    for i in range(steps):
        before = {k: fn.launches for k, fn in routes.items()}
        wg0 = kflash.flash_attention.wg_launches
        bwd_wg0 = kflash.flash_attention_bwd.wg_launches
        batch = data.next_batch()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, m = step(params, opt, batch, i)
        loss, gnorm = float(m["loss"]), float(m["grad_norm"])
        torch.cuda.synchronize()
        rows.append({"s": time.perf_counter() - t0, "loss": loss,
                     "grad_norm": gnorm, "lr": m["lr"],
                     "launches": {k: fn.launches - before[k]
                                  for k, fn in routes.items()},
                     "wg_launches": kflash.flash_attention.wg_launches - wg0,
                     "bwd_wg_launches":
                         kflash.flash_attention_bwd.wg_launches - bwd_wg0})
        print(f"train step {i}: loss {loss:.6f}, grad_norm {gnorm:.6e}, lr "
              f"{m['lr']:.3e}, {rows[-1]['s']:.4f} s, launches "
              f"{rows[-1]['launches']}", flush=True)
        if not np.isfinite(loss) or not np.isfinite(gnorm):
            fail(f"training step {i}: loss {loss}, grad_norm {gnorm}")
    launches = {k: fn.launches for k, fn in routes.items()}
    plain_calls = [obs.value(c) - v for c, v in zip(plain, plain0)]
    L = cfg.num_layers
    L_ssm = L if cfg.family == "hybrid" else 0
    want = {"flash_attention": 2 * L, "flash_attention_bwd": L,
            "ssm_scan": 2 * L_ssm, "ssm_scan_bwd": L_ssm}
    dims = ((cfg.qk_nope_dim + cfg.qk_rope_dim, cfg.v_head_dim) if cfg.mla
            else (cfg.head_dim, cfg.head_dim))
    dtype = getattr(torch, cfg.dtype)
    want_wg = 2 * L if kflash.forward_kernel(
        *dims, dtype) == "flash_kernel_wg" else 0
    bwd_pair = kflash.backward_kernel(*dims, dtype)
    want_bwd_wg = L if "_wg" in bwd_pair[0] else 0
    bad = [r["launches"] for r in rows if r["launches"] != want
           or r["wg_launches"] != want_wg
           or r["bwd_wg_launches"] != want_bwd_wg]
    if bad or any(plain_calls):
        fail(f"training launches a step {bad or rows[0]['launches']} "
             f"(expected {want}: the forward kernels twice a layer under "
             f"remat='full', {want_wg} of them on flash_kernel_wg, "
             f"{want_bwd_wg} backward launches on {bwd_pair} (wgmma)), "
             f"plain dispatches {plain_calls}")
    launches["flash_attention_wg"] = kflash.flash_attention.wg_launches
    launches["flash_attention_bwd_wg"] = \
        kflash.flash_attention_bwd.wg_launches
    print(f"train: {cfg.name}'s attention backward runs {bwd_pair[0]} / "
          f"{bwd_pair[1]}: {rows[0]['bwd_wg_launches']} launches a step on "
          f"wgmma (expected {want_bwd_wg})", flush=True)
    peak = torch.cuda.max_memory_allocated()
    warm = float(np.median([r["s"] for r in rows[1:]]))
    flops = model_flops(cfg, TRAIN_BATCH, TRAIN_SEQ)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    stats = {"params": n_params, "first_s": rows[0]["s"], "warm_s": warm,
             "tokens_per_s": tokens / warm,
             "text_tokens_per_s": TRAIN_BATCH * (TRAIN_SEQ
                                                 - prefix_positions(cfg))
             / warm, "peak_bytes": peak, "model_flops": flops,
             "mfu": flops / warm / PEAK_BF16_TC, "steps": rows,
             "launches": launches, "plain_dispatches": plain_calls}
    print(f"train: {cfg.name} ({L} layers) {n_params:,} parameters "
          f"({cfg.dtype}), remat full, "
          f"{TRAIN_BATCH} x {TRAIN_SEQ} tokens ({prefix_positions(cfg)} "
          f"in front of the text): "
          f"step {rows[0]['s']:.4f} s first, {warm:.4f} s warm (median of "
          f"{len(rows) - 1}); {tokens / warm:,.0f} tokens/s; peak memory "
          f"{peak / 2**30:.2f} GiB; model FLOPs {flops:.4e} a step, "
          f"{100 * stats['mfu']:.2f} % of the bf16 dense peak; launches "
          f"{launches}, plain dispatches {plain_calls}; {smi}", flush=True)
    batch = data.next_batch()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(params, opt, batch, steps)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    idle, longest = device_gaps(prof)
    stats["profile"] = {"wall_s": wall, "device_ms": busy,
                        "launches": sum(e.count for e in kernels),
                        "idle_ms": idle, "longest_gaps_ms": longest}
    print(f"profile: warm train step {wall:.4f} s wall, device busy "
          f"{busy:.2f} ms ({busy / 10 / wall:.2f} %) in "
          f"{stats['profile']['launches']} kernel launches; idle between "
          f"kernels {idle:.2f} ms, longest gaps {[round(g, 3) for g in longest]}"
          f" ms", flush=True)
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<5d} "
              f"{e.key[:90]}")
    for label, keys in (("attention forward", ("flash_kernel",)),
                        ("attention backward", ("delta_kernel",
                                                "dkdv_kernel", "dq_kernel")),
                        ("scan forward", ("ssm_scan_kernel",)),
                        ("scan backward", ("ssm_scan_bwd",))):
        own = [e for e in kernels if any(k in e.key for k in keys)]
        own_ms = sum(e.self_device_time_total for e in own) / 1e3
        stats["profile"][label] = own_ms
        print(f"profile: train step {label} {own_ms:.3f} ms in "
              f"{sum(e.count for e in own)} launches, "
              f"{device_share(own_ms, busy)} of the device time", flush=True)
    del params, opt, step
    torch.cuda.empty_cache()
    return stats


def train_card_vs_cpu(rcfg, seed: int):
    """The reduced ``rcfg``'s (float32) loss and every gradient leaf on the
    card against the CPU, the same weights (drawn on the CPU from ``seed``)
    and ``SyntheticLMData(rcfg, 4, 68, seed)``'s first batch: fails beyond
    ``RTOL_TRAIN_CPU``, or where the card's run dispatched a plain version.
    A leaf with no gradient (the MoE routing bias only selects) counts as
    zero on both. Returns (loss gap, worst gradient gap, backward kernel
    launches on the card)."""
    import torch
    from repro_torch import convert, obs
    from repro_torch.data.pipeline import SyntheticLMData
    from repro_torch.kernels import flash_attention as kflash
    from repro_torch.kernels import ssm_scan as kssm
    from repro_torch.models import LM
    from repro_torch.optim.adamw import leaves
    cpu_params = LM(rcfg, device="cpu").init(
        torch.Generator().manual_seed(seed))
    batch = SyntheticLMData(rcfg, 4, 68, seed).next_batch()
    plain = ("kernels.dispatch.flash_attention.plain",
             "kernels.dispatch.ssm_scan.plain")
    runs = {}
    for where in ("cuda", "cpu"):
        p = convert.lm_params_from_numpy(
            rcfg, convert.lm_params_to_numpy(cpu_params), device=where)
        flat = leaves(p)
        for t in flat:
            t.requires_grad_(True)
        bwd0 = (kflash.flash_attention_bwd.launches,
                kssm.ssm_scan_bwd.launches)
        plain0 = [obs.value(c) for c in plain]
        loss, _ = LM(rcfg, device=where).loss(p, batch)
        runs[where] = (loss.item(), [g.cpu() for g in torch.autograd.grad(
            loss, flat, allow_unused=True, materialize_grads=True)])
        if where == "cuda":
            bwd = {"flash_attention_bwd":
                   kflash.flash_attention_bwd.launches - bwd0[0],
                   "ssm_scan_bwd": kssm.ssm_scan_bwd.launches - bwd0[1]}
            plain_calls = [obs.value(c) - v for c, v in zip(plain, plain0)]
            if any(plain_calls):
                fail(f"reduced {rcfg.name} training on the card dispatched "
                     f"a plain version {plain_calls}")
    loss_gap = abs(runs["cuda"][0] - runs["cpu"][0]) / abs(runs["cpu"][0])
    grad_gap = max(0.0 if not w.abs().max() and not g.abs().max() else
                   rel_gaps([g], [w])[0]
                   for g, w in zip(runs["cuda"][1], runs["cpu"][1]))
    print(f"train parity: reduced {rcfg.name} (float32, 4 x 68 positions) "
          f"card vs CPU: loss {loss_gap:.3e} (gate {RTOL_TRAIN_CPU['loss']}),"
          f" worst of {len(runs['cpu'][1])} gradient leaves {grad_gap:.3e} "
          f"(gate {RTOL_TRAIN_CPU['grads']}); backward kernel launches "
          f"{bwd}", flush=True)
    if loss_gap > RTOL_TRAIN_CPU["loss"] or grad_gap > RTOL_TRAIN_CPU["grads"]:
        fail(f"reduced {rcfg.name} training card vs CPU: loss "
             f"{loss_gap:.3e}, gradients {grad_gap:.3e}")
    return loss_gap, grad_gap, bwd


def training_parity_phase(seed: int):
    """Phase 21: the reduced hymba's loss and gradients on the card against
    the CPU, and a supervised run restarted from its checkpoint (see the
    module docstring). Returns its stats."""
    import tempfile
    import torch
    from repro_torch.checkpoint.ckpt import Checkpointer
    from repro_torch.configs import get_config, reduce_config
    from repro_torch.data.pipeline import SyntheticLMData
    from repro_torch.optim.adamw import leaves
    from repro_torch.runtime.supervisor import Supervisor, SupervisorConfig
    from repro_torch.train.step import init_train_state, make_train_step
    rcfg = reduce_config(get_config("hymba-1.5b"))
    loss_gap, grad_gap, _ = train_card_vs_cpu(rcfg, seed)

    def supervised(directory, fail_at=None, steps=6):
        _, step = make_train_step(rcfg, base_lr=1e-3, warmup=2,
                                  total_steps=steps, device="cuda")
        params, opt = init_train_state(
            rcfg, torch.Generator(device="cuda").manual_seed(seed),
            device="cuda")
        data = SyntheticLMData(rcfg, 4, 68, seed)
        tripped = []

        def inject(s):
            if s == fail_at and not tripped:
                tripped.append(s)
                raise RuntimeError("injected fault")
        sup = Supervisor(step, Checkpointer(directory, keep=3),
                         SupervisorConfig(ckpt_every=2),
                         failure_injector=inject)
        params, _, report = sup.run(params, opt, data, total_steps=steps)
        return params, report, data.state.to_dict()

    with tempfile.TemporaryDirectory() as tmp:
        clean, clean_rep, clean_data = supervised(Path(tmp) / "clean")
        hurt, hurt_rep, hurt_data = supervised(Path(tmp) / "hurt", fail_at=4)
    same = all(torch.equal(a, b) for a, b in zip(leaves(hurt),
                                                  leaves(clean)))
    print(f"train supervisor: 6 steps, failure injected at step 4: "
          f"{hurt_rep.restarts} restart, {hurt_rep.steps_run} steps run, "
          f"data state {hurt_data} (uninjected {clean_data}), losses equal "
          f"{hurt_rep.losses == clean_rep.losses}, parameters bit-equal to "
          f"the uninjected run {same}", flush=True)
    if not (same and hurt_rep.restarts == 1 and hurt_data == clean_data
            and hurt_rep.losses == clean_rep.losses):
        fail("the supervisor's restart did not resume training bit for bit")
    return {"loss_gap": loss_gap, "grad_gap": grad_gap,
            "restarts": hurt_rep.restarts, "bit_equal": same,
            "losses": clean_rep.losses}


def serve_batch(cfg, requests: int, positions: int, seed: int):
    """The prompts of a serve phase as numpy arrays from ``seed``: tokens
    (requests, positions); a vision model's patches (unit normal) fill the
    first ``num_patches`` positions, the tokens the rest; an audio model's
    codes (requests, nq, positions) and its condition (unit normal)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    if cfg.audio_codebooks:
        return {"codes": rng.integers(0, cfg.vocab_size, (
                    requests, cfg.audio_codebooks, positions)).astype(np.int32),
                "cond": rng.normal(size=(requests, cfg.cond_len,
                                         cfg.cond_dim)).astype(np.float32)}
    text = positions - (cfg.num_patches if cfg.vision else 0)
    batch = {"tokens": rng.integers(0, cfg.vocab_size,
                                    (requests, text)).astype(np.int32)}
    if cfg.vision:
        batch["patches"] = rng.normal(size=(
            requests, cfg.num_patches, cfg.vision_dim)).astype(np.float32)
    return batch


def serve_noise(rcfg, seed: int) -> float:
    """The reduced ``rcfg``'s own float32 noise on the card, on
    ``reduced_card_vs_cpu``'s weights and prompts: max over the prefill's
    and 24 decode steps' logits of max|nudged - plain| / max|plain|, where
    the nudged run's weights are each moved by half a float32 ulp (signs
    from ``seed + 1``) and both runs decode the plain run's greedy
    tokens."""
    import torch
    from repro_torch import convert
    from repro_torch.models import LM
    cpu_params = LM(rcfg, device="cpu").init(
        torch.Generator().manual_seed(seed))
    signs = torch.Generator().manual_seed(seed + 1)

    def nudge(t):
        if t.dtype != torch.float32:
            return t
        s = torch.randint(0, 2, t.shape, generator=signs) * 2 - 1
        return (t.double() * (1 + s * 2.0 ** -24)).float()
    rbatch = serve_batch(rcfg, 4, 40, seed)
    lm = LM(rcfg, device="cuda")
    runs, toks = [], []
    with torch.inference_mode():
        for p_ in (cpu_params, tree_map(nudge, cpu_params)):
            params = convert.lm_params_from_numpy(
                rcfg, tree_map(lambda t: t.numpy(), p_), device="cuda")
            cache, logits = lm.prefill(params, rbatch, max_seq=64)
            steps = [logits.float().cpu()]
            for i in range(24):
                if len(toks) < 24:
                    toks.append(logits.argmax(-1).to(torch.int32))
                logits, cache = lm.decode(params, cache, {"tokens": toks[i]})
                steps.append(logits.float().cpu())
            runs.append(steps)
    return max(((n - p).abs().max() / p.abs().max()).item()
               for p, n in zip(*runs))


def reduced_card_vs_cpu(rcfg, seed: int, gate: float = RTOL_SERVE_CPU):
    """The reduced ``rcfg`` (float32) served on the card and on the CPU with
    the same weights (drawn on the CPU from ``seed``, carried to the card by
    ``convert``), 4 x 40-position prompts (``serve_batch``), 24 greedy
    steps: fails unless the tokens are identical and every step's logits
    (the prefill's and each decode step's) are within ``gate``
    (``RTOL_SERVE_CPU`` unless phase 39 gives one). Returns the worst
    gap."""
    import numpy as np
    import torch
    from repro_torch import convert
    from repro_torch.models import LM
    from repro_torch.serve.engine import Engine
    cpu_params = LM(rcfg, device="cpu").init(
        torch.Generator().manual_seed(seed))
    card_params = convert.lm_params_from_numpy(
        rcfg, tree_map(lambda t: t.numpy(), cpu_params), device="cuda")
    rbatch = serve_batch(rcfg, 4, 40, seed)
    runs = {}
    for where, p_ in (("cuda", card_params), ("cpu", cpu_params)):
        eng = Engine(rcfg, p_, max_seq=64, device=where)
        r = record_steps(eng)
        runs[where] = (eng.generate(rbatch, steps=24),
                       [t.float().cpu() for t in r["logits"]])
    (tok_g, log_g), (tok_c, log_c) = runs["cuda"], runs["cpu"]
    parity = max(((g - c).abs().max() / c.abs().max()).item()
                 for g, c in zip(log_g, log_c))
    if not np.array_equal(tok_g, tok_c) or parity > gate:
        fail(f"reduced {rcfg.name} card vs CPU: tokens equal "
             f"{np.array_equal(tok_g, tok_c)}, logits max rel {parity:.3e} "
             f"(gate {gate:.3e})")
    print(f"parity: reduced {rcfg.name} card vs CPU, 4 x 40-position prompts, "
          f"24 steps: tokens identical, logits max rel {parity:.3e} (gate "
          f"{gate:.3e})", flush=True)
    return parity


def fwd_wg_kernels():
    """{kernel: ptxas report} and ptxas's wgmma notes of the bf16 forward's
    wgmma kernel (``flash_kernel_wg<D, Dv, split>``, both treatments of p),
    from the build's report kept beside the library."""
    import re
    from repro_torch.kernels import build
    log = build.build_library("flash_attention").with_suffix(
        ".log").read_text()
    kernels = {}
    for name, rep in ptxas_kernels(log).items():
        m = re.search(r"flash_kernel_wgILi(\d+)ELi(\d+)ELb([01])E", name)
        if m:
            p = "p float32" if m[3] == "1" else "p rounded"
            kernels[f"flash_kernel_wg<{m[1]}, {m[2]}> {p}"] = rep
    notes = [line.strip() for line in log.splitlines()
             if "wgmma" in line and "flash_kernel_wg" in line]
    return kernels, notes


def attention_shapes_phase(shapes, n_timed: int, seed: int):
    """Phases 22 and 26: the flash-attention kernel against its plain
    version at ``shapes`` ((B, H, K, S, D) or (B, H, K, S, Dqk, Dv); causal;
    float32 and bf16, p rounded and in float32; the gates of phase 8), one
    wgmma launch a call where the forward runs ``flash_kernel_wg`` and none
    elsewhere, and at the first ``n_timed`` (full-width) shapes its time
    (``median_ms``) with p in float32 (the model's call) and rounded
    (SDPA's p), its bound, the plain version's time and SDPA's, where SDPA
    takes the call; where a shape runs ``flash_kernel_wg``, that kernel's
    registers and spills (``fwd_wg_kernels``), failing on a spill store.
    Returns stats."""
    import torch
    from repro_torch.kernels import flash_attention as kflash
    from repro_torch.kernels import ref
    dev = torch.device("cuda")
    sdpa = torch.nn.functional.scaled_dot_product_attention
    stats = {"max_abs_err": 0.0, "max_ulps": 0.0, "max_share": 0.0,
             "wg_max_abs_err": 0.0, "wg_launches": 0, "timing": {}}
    for shape in shapes:
        D, Dv = shape[4], shape[5] if len(shape) > 5 else shape[4]
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = attn_inputs(shape, dtype, seed, dev)
            wg = kflash.forward_kernel(D, Dv, dtype) == "flash_kernel_wg"
            for round_p in (True, False):
                n0 = kflash.flash_attention.wg_launches
                got = kflash.flash_attention(q, k, v, round_p=round_p)
                want = ref.attention_ref(q, k, v, round_p=round_p)
                torch.cuda.synchronize()
                label = (f"flash_attention {shape} {dtype} causal "
                         f"round_p={round_p}")
                launched = kflash.flash_attention.wg_launches - n0
                if launched != int(wg):
                    fail(f"{label}: {launched} flash_kernel_wg launches, "
                         f"expected {int(wg)}")
                stats["wg_launches"] += launched
                if not torch.isfinite(got).all() or got.shape != want.shape:
                    fail(f"{label}: output not finite or of shape "
                         f"{tuple(got.shape)}")
                err = (got.float() - want.float()).abs().max().item()
                stats["max_abs_err"] = max(stats["max_abs_err"], err)
                if wg:
                    stats["wg_max_abs_err"] = max(stats["wg_max_abs_err"],
                                                  err)
                if dtype == torch.bfloat16 and not round_p:
                    ulps, share = ref.bf16_ulp_gaps(got, want)
                    stats["max_ulps"] = max(stats["max_ulps"], ulps)
                    stats["max_share"] = max(stats["max_share"], share)
                    print(f"kernel {label}: max abs err {err:.3e}, {ulps:.3g} "
                          f"ulp, {100 * share:.4f} % of elements differ "
                          f"(gates {MAX_ULPS_P_F32} ulp, "
                          f"{100 * MAX_SHARE_P_F32} %)")
                    if ulps > MAX_ULPS_P_F32 or share > MAX_SHARE_P_F32:
                        fail(f"{label}: {ulps} ulp, share {share}")
                    continue
                tol = TOL_ATTN[str(dtype).split(".")[1]]
                print(f"kernel {label}: max abs err {err:.3e} (tol {tol})")
                if err > tol:
                    fail(f"{label}: max abs err {err:.3e} > {tol}")
    if stats["wg_launches"]:
        kernels, notes = fwd_wg_kernels()
        spilled = {n: r for n, r in kernels.items()
                   if r.get("spill_stores", 0) > 0}
        pairs = kflash.WGMMA_FWD_PAIRS
        print(f"route flash_attention bf16 {', '.join(map(str, pairs))}: "
              "wgmma; " + "; ".join(f"{n} {r.get('registers')} registers, "
                                    f"{r.get('spill_stores')} B of spill "
                                    f"stores, {r.get('spill_loads')} B of "
                                    f"spill loads"
                                    for n, r in sorted(kernels.items())),
              flush=True)
        for line in notes:
            print(f"ptxas: {line}", flush=True)
        if len(kernels) != 2 * len(pairs) or spilled:
            fail(f"flash_kernel_wg: {len(kernels)} instantiations in the "
                 f"build (want {2 * len(pairs)}), spills {spilled}")
        stats["registers"], stats["ptxas_notes"] = kernels, notes
    for shape in shapes[:n_timed]:
        B, H, K, S, D = shape[:5]
        Dv = shape[5] if len(shape) > 5 else D
        q, k, v = attn_inputs(shape, torch.bfloat16, seed, dev)
        b_ms, b_by = attn_bound(B, H, K, S, D, 2, Dv=Dv)
        t = {"ms": median_ms(lambda: kflash.flash_attention(
                 q, k, v, round_p=False)),
             "ms_round_p": median_ms(lambda: kflash.flash_attention(
                 q, k, v, round_p=True)),
             "plain_ms": time_ms(lambda: ref.attention_ref(
                 q, k, v, round_p=False), 5, 1),
             "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
             "kernel": kflash.forward_kernel(D, Dv, torch.bfloat16)}
        try:
            t["library_ms"] = median_ms(lambda: sdpa(q, k, v, is_causal=True,
                                                     enable_gqa=True))
        except RuntimeError as err:
            print(f"SDPA does not take {shape}: {str(err).splitlines()[0]}")
        stats["timing"][str(shape)] = t
        lib = "n/a" if t["library_ms"] is None else f"{t['library_ms']:.4f}"
        ratio = ("" if t["library_ms"] is None else
                 f", {t['ms_round_p'] / t['library_ms']:.2f}x SDPA")
        print(f"timing flash_attention {shape} bf16 causal ({t['kernel']}): "
              f"kernel {t['ms']:.4f} ms with p float32, {t['ms_round_p']:.4f}"
              f" ms with p rounded{ratio}, plain {t['plain_ms']:.4f} ms, SDPA "
              f"{lib} ms, bound {b_ms:.4f} ms ({b_by}), "
              f"{100 * b_ms / t['ms']:.1f} % of it", flush=True)
    return stats


def expert_stream_ms(cfg) -> float:
    """The least time of a decode step's expert weights: every MoE layer
    reads each expert's three matrices once (bf16) at the memory rate."""
    n_moe = cfg.num_layers - cfg.first_dense_layers
    nbytes = n_moe * cfg.num_experts * 3 * cfg.d_model * cfg.moe_d_ff * 2
    return nbytes / PEAK_BYTES * 1e3


def kernel_launches():
    """Every kernel wrapper's launch count."""
    from repro_torch.kernels import flash_attention as kflash
    from repro_torch.kernels import retention as kretention
    from repro_torch.kernels import ssm_scan as kssm
    return {"flash_attention": kflash.flash_attention.launches,
            "flash_attention_bwd": kflash.flash_attention_bwd.launches,
            "ssm_scan": kssm.ssm_scan.launches,
            "ssm_scan_bwd": kssm.ssm_scan_bwd.launches,
            "retention": kretention.retention_batch.launches}


def requirements_phase(smi: str):
    """Phase 31: requirements from models on the card (see the module
    docstring). Returns its stats; ``launches`` is the retention kernel's
    launches in the warm arch-task ``explore``."""
    import tempfile

    import torch
    from repro_torch import api, obs, sim
    from repro_torch.core.select import SelectionPolicy
    from repro_torch.hetero import compose
    from repro_torch.kernels import retention as kretention
    from repro_torch.launch import dryrun, roofline
    from repro_torch.profiler import traffic
    from repro_torch.sim.rerank import composition_idx, simulate_report

    def dispatches():
        return (obs.value("kernels.dispatch.retention.cuda"),
                obs.value("kernels.dispatch.retention.plain"))

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    stats = {}
    with tempfile.TemporaryDirectory() as tmp:
        # 1. the records of every cell, on the meta device
        rc, stats["records_s"] = timed(lambda: dryrun.main(
            ["--all", "--out", tmp]))
        recs = [json.loads(p.read_text())
                for p in sorted(Path(tmp).glob("*.json"))]
        counts = {k: sum(r["status"] == k for r in recs)
                  for k in DRYRUN_CELLS}
        uncounted = [f"{r['arch']}/{r['shape']}" for r in recs
                     if r["status"] == "ok"
                     and not r["collective_bytes_per_device"] > 0]
        print(f"requirements: dryrun --all: {len(recs)} records, "
              f"{counts['ok']} ok, {counts['skipped']} skipped, exit {rc}, "
              f"{stats['records_s']:.2f} s in up to {dryrun.JOBS} "
              f"processes (each cell's collectives counted in a full-width "
              f"step on the meta device); {smi}", flush=True)
        if rc != 0 or counts != DRYRUN_CELLS or len(recs) != 40:
            fail(f"dryrun --all: exit {rc}, {len(recs)} records, {counts}")
        if uncounted:
            fail(f"dryrun records with no collective bytes: {uncounted}")
        # 2. their roofline, and the collective term's part of each row
        rows = roofline.load_table(tmp)
        print(f"requirements: roofline.load_table: {len(rows)} rows")
        if len(rows) != DRYRUN_CELLS["ok"]:
            fail(f"roofline: {len(rows)} rows")
        stats["collective_share"] = {}
        for r in rows:
            bound = max(r["t_compute_s"], r["t_memory_s"],
                        r["t_collective_s"])
            share = r["t_collective_s"] / bound
            stats["collective_share"][f"{r['arch']}/{r['shape']}"] = share
            print(f"  {r['arch']:22s} {r['shape']:12s} collective "
                  f"{r['t_collective_s']:.4e} s = {share:.4f} of the row's "
                  f"bound ({r['bottleneck']} binds)")

        # 3. explore over the arch tasks: card (cold, warm) against the CPU
        tasks = traffic.available_arch_tasks(ARCH_SHAPES, outdir=tmp)
        space = api.design_space(mem_types=ARCH_MEM_TYPES)
        policy = SelectionPolicy(preference=ARCH_PREFERENCE,
                                 allow_refresh=True)

        def explore(device):
            return api.explore(space=space, tasks=tasks, policy=policy,
                               device=device)
        d0 = dispatches()
        card, cold_s = timed(lambda: explore("cuda"))
        d1 = dispatches()
        kretention.retention_batch.launches = 0
        card, warm_s = timed(lambda: explore("cuda"))
        launches = kretention.retention_batch.launches
        d2 = dispatches()
        prof = profile_report("warm explore over the arch tasks",
                              lambda: explore("cuda"))
        cpu = explore("cpu")
        labels = card.labels()
        # the same explore on the records with no collective term (what
        # they held before the collectives were counted)
        zeroed = Path(tmp) / "no_collectives"
        zeroed.mkdir()
        for r in recs:
            if r["status"] == "ok":
                r = dict(r, collectives={}, collective_bytes_per_device=0.0)
            (zeroed / f"{r['arch']}__{r['shape']}__{r['mesh']}.json") \
                .write_text(json.dumps(r))
        before = api.explore(space=space, policy=policy, device="cuda",
                             tasks=traffic.available_arch_tasks(
                                 ARCH_SHAPES, outdir=str(zeroed))).labels()
        moved = {tid: (before[tid], lv) for tid, lv in labels.items()
                 if before.get(tid) != lv}
        stats["picks_moved_by_collectives"] = moved
        print(f"requirements: {len(moved)} of {len(labels)} arch-task picks "
              f"move once collectives are counted: "
              + ("; ".join(f"{tid}: {a['L1']}/{a['L2']} -> {b['L1']}/"
                           f"{b['L2']}" for tid, (a, b) in moved.items())
                 or "none"), flush=True)
        hetero = sum("+" in lv["L2"] or lv["L1"] != lv["L2"]
                     for lv in labels.values())
        print(f"requirements: explore over {len(tasks)} arch tasks, "
              f"{len(card.table)} configs: {cold_s:.4f} s cold, "
              f"{warm_s:.4f} s warm ({launches} retention launch(es), "
              f"device {prof['device_ms']:.4f} ms in {prof['launches']} "
              f"kernel launches); {hetero} heterogeneous picks; {smi}",
              flush=True)
        for tid, lv in labels.items():
            print(f"  {tid:32s} L1={lv['L1']:14s} L2={lv['L2']}")
        if len(tasks) != 20 or labels != cpu.labels():
            fail(f"explore over {len(tasks)} arch tasks: card labels equal "
                 f"to the CPU's: {labels == cpu.labels()}")
        if not (d1[0] > d0[0] and d2[0] > d1[0] and launches >= 1) \
                or d2[1] != d0[1]:
            fail(f"explore over the arch tasks: retention dispatches "
                 f"(cuda, plain) {d0} -> {d1} -> {d2}, {launches} launches")

        # 4. compose and the trace-replay re-rank on the arch traces
        arch, shape = ARCH_SIM_CELL
        rec = traffic.load_dryrun_record(arch, shape, outdir=tmp)
        task = traffic.arch_task(arch, shape, rec)
        traces = traffic.arch_traces(arch, shape, rec=rec)

        def simulate(device):
            rep = compose(space, task, policy=policy, device=device)
            return simulate_report(rep, traces=traces, device=device)
        sim_card, sim_s = timed(lambda: simulate("cuda"))
        sim_cpu = simulate("cpu")
        order = composition_idx(sim_card).tolist()
        gap = max(max_rel([a.metrics[f"sim_{m}"] for a in sim_card.ranked],
                          [b.metrics[f"sim_{m}"] for b in sim_cpu.ranked])
                  for m in sim.SIM_METRICS)
        print(f"requirements: compose + simulate_report({arch}/{shape}, "
              f"arch_traces): {len(order)} compositions, {sim_s:.4f} s on "
              f"the card, order equal to the CPU's "
              f"{order == composition_idx(sim_cpu).tolist()}, sim_* max "
              f"rel {gap:.3e} (gate {RTOL_SIM}), labels "
              f"{sim_card.labels()}; {smi}", flush=True)
        if order != composition_idx(sim_cpu).tolist() or gap > RTOL_SIM \
                or sim_card.refined != "simulate":
            fail(f"compose + simulate of {arch}/{shape}: orders equal "
                 f"{order == composition_idx(sim_cpu).tolist()}, sim_* gap "
                 f"{gap:.3e}")

        # 5. the records stamped with their picks, on the card
        cells = [(json.loads(p.read_text()), p)
                 for p in sorted(Path(tmp).glob("*.json"))]
        d3 = dispatches()
        report, annotate_s = timed(lambda: dryrun.memory_dse_annotate(
            cells, Path(tmp), device="cuda"))
        d4 = dispatches()
        stamped = {f"{r['arch']}/{r['shape']}": r["memory_dse"]
                   for r in (json.loads(p.read_text())
                             for p in Path(tmp).glob("*.json"))
                   if "memory_dse" in r}
        want = api.explore(tasks=report.tasks,
                           policy=SelectionPolicy(allow_refresh=True),
                           device="cpu").labels()
        print(f"requirements: memory_dse_annotate: {len(stamped)} records "
              f"stamped in {annotate_s:.4f} s, equal to the CPU's explore "
              f"{stamped == want}; {smi}", flush=True)
        if stamped != want or len(stamped) != DRYRUN_CELLS["ok"] \
                or d4[0] <= d3[0] or d4[1] != d3[1]:
            fail(f"memory_dse_annotate: {len(stamped)} stamped, equal to "
                 f"the CPU's {stamped == want}, retention dispatches "
                 f"{d3} -> {d4}")
    stats.update({
        "records": counts, "roofline_rows": len(rows),
        "explore": {"tasks": len(tasks), "configs": len(card.table),
                    "cold_s": cold_s, "warm_s": warm_s,
                    "warm_device_ms": prof["device_ms"],
                    "warm_kernel_launches": prof["launches"],
                    "heterogeneous": hetero, "labels": labels},
        "simulate": {"cell": f"{arch}/{shape}", "s": sim_s,
                     "compositions": len(order), "max_rel": gap},
        "annotate": {"stamped": len(stamped), "s": annotate_s},
        "launches": launches})
    return stats


def serve_full_phase(arch: str, n_layers, seed: int):
    """Phases 23-24 and 27-29: ``arch`` at full width (``n_layers`` layers
    kept, None = all), bf16 weights from ``seed``, served by
    ``Engine.generate`` (4 x 1,000-position prompts from ``serve_batch``,
    32 greedy steps, max_seq 1,040) twice: one flash-attention launch a
    layer a prefill (none for the xLSTM) and no other kernel launch or
    plain dispatch, tokens (codes) in the vocabulary, logits and the last
    decode cache (the xLSTM states) finite, the two calls' tokens
    identical; with MLA the decode cache is the latent one and each step
    wrote its row. Prints init and generate seconds and peak memory, warm
    prefill seconds, decode tokens/s and a decode step's least time (a MoE
    model's expert stream; else every bf16 weight read once). Profiles a
    warm prefill (the xLSTM's over ``XLSTM_PROFILE_PROMPT`` positions) and
    decode step. Frees the model. Returns stats."""
    import gc
    import numpy as np
    import torch
    from repro_torch import obs
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as kflash
    from repro_torch.models import LM
    from repro_torch.serve.engine import Engine
    dev = torch.device("cuda")
    cfg = get_config(arch)
    if n_layers is not None:
        cfg = cfg.replace(num_layers=n_layers)
    attn_layers = 0 if cfg.family == "ssm" else cfg.num_layers
    # the attention launches that run flash_kernel_wg (bf16 at the pairs
    # kflash.WGMMA_FWD_PAIRS names): all of them, or none
    dims = ((cfg.qk_nope_dim + cfg.qk_rope_dim, cfg.v_head_dim) if cfg.mla
            else (cfg.head_dim, cfg.head_dim))
    wg_layers = attn_layers if attn_layers and kflash.forward_kernel(
        *dims, torch.bfloat16) == "flash_kernel_wg" else 0
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = LM(cfg, dev).init(torch.Generator(device=dev).manual_seed(seed))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    gib = 2 ** 30
    nbytes = sum(t.numel() * t.element_size() for t in to_leaves(params))
    stats = {"layers": cfg.num_layers, "init_s": init_s,
             "params": sum(t.numel() for t in to_leaves(params)),
             "params_gib": nbytes / gib,
             "init_peak_gib": torch.cuda.max_memory_allocated() / gib}
    if cfg.moe:
        stats["step_least_ms"] = stats["expert_stream_ms"] = \
            expert_stream_ms(cfg)
        least = "the expert stream's least time"
    else:
        stats["step_least_ms"] = nbytes / PEAK_BYTES * 1e3
        least = "every weight read once"
    shape = (f"{cfg.num_experts} experts top-{cfg.top_k}"
             f"{', MLA' if cfg.mla else ''}{', MTP' if cfg.mtp else ''}"
             if cfg.moe else f"{cfg.family}")
    print(f"serve: {arch} at full width, {cfg.num_layers} layers (d_model "
          f"{cfg.d_model}, {shape}): {stats['params']:,} parameters "
          f"({stats['params_gib']:.2f} GiB), initialized on the card in "
          f"{init_s:.2f} s, peak {stats['init_peak_gib']:.2f} GiB",
          flush=True)
    batch = serve_batch(cfg, SERVE_REQUESTS, SERVE_PROMPT, seed)
    want_shape = (SERVE_REQUESTS, SERVE_STEPS) + (
        (cfg.audio_codebooks,) if cfg.audio_codebooks else ())
    engine = Engine(cfg, params, max_seq=SERVE_MAX_SEQ, device=dev)
    rec = record_steps(engine)
    outs = []
    for call in ("first", "warm"):
        n_logits = len(rec["logits"])
        plain0 = obs.value("kernels.dispatch.flash_attention.plain")
        cuda0 = obs.value("kernels.dispatch.flash_attention.cuda")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        launches0 = kernel_launches()
        wg0 = kflash.flash_attention.wg_launches
        t0 = time.perf_counter()
        outs.append(engine.generate(batch, steps=SERVE_STEPS))
        torch.cuda.synchronize()
        total_s = time.perf_counter() - t0
        launched = {k: v - launches0[k] for k, v in kernel_launches().items()}
        launches = launched.pop("flash_attention")
        wg_launches = kflash.flash_attention.wg_launches - wg0
        plain = obs.value("kernels.dispatch.flash_attention.plain") - plain0
        dispatched = obs.value("kernels.dispatch.flash_attention.cuda") \
            - cuda0
        run = {"generate_s": total_s, "prefill_s": rec["prefill_s"][-1],
               "decode_tok_s": SERVE_REQUESTS * SERVE_STEPS
               / (total_s - rec["prefill_s"][-1]),
               "decode_step_s": (total_s - rec["prefill_s"][-1]) / SERVE_STEPS,
               "launches": launches, "wg_launches": wg_launches,
               "plain_dispatches": plain,
               "peak_gib": torch.cuda.max_memory_allocated() / gib}
        stats[call] = run
        logits = rec["logits"][n_logits:]
        if not all(torch.isfinite(t).all().item() for t in logits):
            fail(f"{arch} ({call} call): non-finite logits")
        if not all(torch.isfinite(t).all().item()
                   for t in to_leaves(rec["cache"])
                   if isinstance(t, torch.Tensor) and t.is_floating_point()):
            fail(f"{arch} ({call} call): a decode cache leaf is not finite")
        if outs[-1].shape != want_shape or \
                outs[-1].min() < 0 or outs[-1].max() >= cfg.vocab_size:
            fail(f"{arch} ({call} call): tokens {outs[-1].shape} outside "
                 f"the vocabulary (expected {want_shape})")
        if launches != attn_layers or dispatched != launches or plain or \
                any(launched.values()) or wg_launches != wg_layers:
            fail(f"{arch} ({call} call): {launches} flash_attention launches "
                 f"(expected {attn_layers}, one an attention layer), "
                 f"{wg_launches} of them on flash_kernel_wg (expected "
                 f"{wg_layers}), {dispatched} counted by kernels.dispatch."
                 f"flash_attention.cuda, {plain} plain dispatches, other "
                 f"kernels {launched}")
        print(f"serve {arch} ({call} call): generate {total_s:.4f} s, prefill "
              f"{run['prefill_s']:.4f} s, decode {run['decode_tok_s']:.1f} "
              f"tokens/s ({1e3 * run['decode_step_s']:.2f} ms a step; {least}"
              f" {stats['step_least_ms']:.3f} ms), {launches} flash_attention "
              f"launches ({wg_launches} on flash_kernel_wg), {plain} plain, "
              f"no other kernel, peak "
              f"{run['peak_gib']:.2f} GiB, {len(logits)} logit sets and the "
              f"decode cache finite", flush=True)
    if not np.array_equal(outs[0], outs[1]):
        fail(f"{arch}: two generate calls gave different tokens")
    if cfg.mla:     # the absorbed decode wrote the latent cache, row by row
        written = SERVE_PROMPT + SERVE_STEPS
        for seg, (ckv, kr) in ((k, v) for k, v in rec["cache"].items()
                               if k != "pos"):
            if ckv.shape[-1] != cfg.kv_lora_rank or \
                    kr.shape[-1] != cfg.qk_rope_dim or \
                    not bool((ckv[:, :, :written].abs().amax(-1) > 0).all()) \
                    or bool(ckv[:, :, written:].any()):
                fail(f"{arch}: the latent decode cache of {seg} "
                     f"{tuple(ckv.shape)}, {tuple(kr.shape)} is not the "
                     f"absorbed decode's ({written} rows written)")
        print(f"serve {arch}: latent decode cache (kv_lora "
              f"{cfg.kv_lora_rank} + rope {cfg.qk_rope_dim} a token) written "
              f"through row {written - 1}", flush=True)
    positions = XLSTM_PROFILE_PROMPT if cfg.family == "ssm" else SERVE_PROMPT
    pbatch = serve_batch(cfg, SERVE_REQUESTS, positions, seed)
    with torch.inference_mode():     # where a warm prefill's and decode
        lm, box = engine.lm, {}       # step's device time goes
        prof = profile_report(
            f"{arch} prefill ({positions} positions)",
            lambda: box.update(zip(("cache", "logits"), lm.prefill(
                params, pbatch, max_seq=SERVE_MAX_SEQ))))
        stats["prefill_profile"] = {k: prof[k] for k in
                                    ("wall_s", "device_ms", "launches")}
        stats["prefill_profile"]["positions"] = positions
        tok = {"tokens": box["logits"].argmax(-1)}
        if "cond" in pbatch:          # an audio model's condition
            tok["cond"] = pbatch["cond"]
        lm.decode(params, box["cache"], tok)
        prof = profile_report(f"{arch} warm decode step", lambda: lm.decode(
            params, box["cache"], tok))
        stats["decode_profile"] = {k: prof[k] for k in
                                   ("wall_s", "device_ms", "launches")}
    del engine, params, rec, box, lm
    gc.collect()
    torch.cuda.empty_cache()
    return stats


def load_file(relpath: str):
    """The module at ``relpath`` of the checkout (a script or example, not
    a package module), imported under its file's stem."""
    import importlib.util
    path = ROOT / relpath
    spec = importlib.util.spec_from_file_location(path.stem, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def examples_phase():
    """Phase 41: the smoke script over every reduced arch and the four
    examples on the card (see the module docstring). Fails if one of them
    fails its own check, prints a non-finite value, dispatches a plain
    version or launches none of the kernels its path runs. Returns {name:
    {"s", "launches"}} with its result's checked fields."""
    import contextlib
    import io
    import tempfile
    import numpy as np
    from repro_torch import obs

    def plain():
        return [obs.value(f"kernels.dispatch.{op}.plain")
                for op in ("flash_attention", "ssm_scan", "retention")]

    def run(name, module, argv):
        launches0, plain0 = kernel_launches(), plain()
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            result = module.main(argv)
        seconds = time.perf_counter() - t0
        print(out.getvalue(), end="", flush=True)
        launched = {k: v - launches0[k] for k, v in kernel_launches().items()}
        plain_calls = [b - a for a, b in zip(plain0, plain())]
        if any(plain_calls):
            fail(f"{name} dispatched a plain version on the card "
                 f"{plain_calls}")
        stats[name] = {"s": seconds, "launches": launched}
        print(f"examples: {name} {seconds:.2f} s, kernel launches "
              f"{launched}", flush=True)
        return result, out.getvalue(), launched

    stats = {}
    rc, _, launched = run("smoke_models_torch",
                          load_file("scripts/smoke_models_torch.py"), [])
    if rc != 0 or not launched["flash_attention"] or \
            not launched["ssm_scan"]:
        fail(f"scripts/smoke_models_torch.py: exit code {rc}, launches "
             f"{launched}")
    # each example characterizes into a cache of its own, so that each one
    # launches the retention kernel
    with tempfile.TemporaryDirectory() as tmp:
        out, _, launched = run("torch_quickstart",
                               load_file("examples/torch_quickstart.py"),
                               ["--out", tmp])
        if not (out["drc_clean"] and out["lvs_clean"]) or \
                not launched["retention"]:
            fail(f"examples/torch_quickstart.py: DRC clean "
                 f"{out['drc_clean']}, LVS clean {out['lvs_clean']}, "
                 f"launches {launched}")
        out, text, launched = run(
            "torch_heterogeneous_dse",
            load_file("examples/torch_heterogeneous_dse.py"),
            ["--cache", str(Path(tmp) / "dse")])
        oks = sum(line.lstrip().startswith("OK ")
                  for line in text.splitlines())
        if out["ok"] != 7 or oks != 7 or not launched["retention"]:
            fail(f"examples/torch_heterogeneous_dse.py: Table 2 {out['ok']}"
                 f"/7, {oks} lines OK, launches {launched}")
        stats["torch_heterogeneous_dse"]["ok"] = oks
        out, _, launched = run("torch_serve_lm",
                               load_file("examples/torch_serve_lm.py"), [])
        if not out["deterministic"] or not all(out["launches"].values()):
            fail(f"examples/torch_serve_lm.py: greedy determinism "
                 f"{out['deterministic']}, launches {out['launches']}")
        stats["torch_serve_lm"]["deterministic"] = out["deterministic"]
        report, _, launched = run(
            "torch_train_lm", load_file("examples/torch_train_lm.py"),
            ["--steps", str(EXAMPLE_TRAIN_STEPS), "--ckpt-dir",
             str(Path(tmp) / "ckpt")])
        if report.steps_run != EXAMPLE_TRAIN_STEPS or report.restarts or \
                not launched["flash_attention_bwd"]:
            fail(f"examples/torch_train_lm.py: {report.steps_run} steps, "
                 f"{report.restarts} restarts, launches {launched}")
        stats["torch_train_lm"].update(
            steps=report.steps_run, restarts=report.restarts,
            loss_first10=float(np.mean(report.losses[:10])),
            loss_last10=float(np.mean(report.losses[-10:])))
    return stats


def sharded_mesh(world: int):
    """Phase 32's ("data", "model") mesh over ``world`` cards: (2, 2) on 4,
    (1, 1) on one."""
    if world % 2 == 0:
        return (world // 2, 2)
    return (world, 1)


def sharded_phase(seed: int, smi: str):
    """Phase 32 (see the module docstring). Returns its stats."""
    import torch
    from repro_torch.configs import get_config
    world = torch.cuda.device_count()
    mesh = sharded_mesh(world)
    print(f"sharded: world {world}, mesh {mesh} (data, model), NCCL; {smi}",
          flush=True)
    base = dict(mesh=mesh, batch=TRAIN_BATCH, seq=TRAIN_SEQ, data_seed=seed,
                seed=seed, base_lr=TRAIN_LR, warmup=2,
                total_steps=TRAIN_STEPS, steps=[0, 1], warm=2)
    ep, gathered = {"REPRO_MOE_SHARDMAP": "1"}, {"REPRO_MOE_SHARDMAP": "0"}
    moon = get_config("moonshot-v1-16b-a3b")
    f32_2l = {"num_layers": 2, "dtype": "float32"}
    dropless = dict(f32_2l, capacity_factor=moon.num_experts / moon.top_k)
    noise = world > 1       # (1, 1) is held to bit equality, not noise
    runs = {"hymba-1.5b-2L-f32": dict(base, arch="hymba-1.5b",
                                      overrides=f32_2l, single=True),
            "moonshot-2L-f32-gathered": dict(
                base, arch="moonshot-v1-16b-a3b", overrides=dropless,
                env=gathered, single=True, noise=noise),
            "moonshot-2L-f32-ep": dict(
                base, arch="moonshot-v1-16b-a3b", overrides=dropless,
                env=ep, single=True, noise=noise),
            "deepseek-v3-2L-f32": dict(
                base, arch="deepseek-v3-671b",
                overrides=dict(TRAIN_MLA[1], dtype="float32"), single=True),
            "hymba-1.5b": dict(base, arch="hymba-1.5b", single=True,
                               noise=noise, profile=True)}
    # the model no card holds alone gets a launch of its own, after the
    # others have printed
    launches = [runs]
    if world >= 4:
        launches.append({f"moonshot-{SHARDED_DEEP_LAYERS}L-ep": dict(
            base, arch="moonshot-v1-16b-a3b", env=ep, steps=[0],
            profile=True, overrides={"num_layers": SHARDED_DEEP_LAYERS})})
    stats = {"world": world, "mesh": list(mesh), "smi": smi, "runs": {},
             "beyond_gates": []}
    for group in launches:
        sharded_runs(group, world, mesh, stats)
    deep = [k for k in stats["runs"]
            if k.startswith(f"moonshot-{SHARDED_DEEP_LAYERS}")]
    if deep:
        n = stats["runs"][deep[0]]["params"]
        print(f"sharded {deep[0]}: {n:,} parameters x 12 B (bf16 "
              f"parameters and gradients, float32 moments) = "
              f"{12 * n / 1e9:.1f} GB of state before activations, above "
              f"one card's 80 GB", flush=True)
    if stats["beyond_gates"]:
        fail(f"sharded runs beyond the gates: {stats['beyond_gates']}")
    return stats


def sharded_beyond(out, world: int):
    """The gates ``out`` (a ``train_check`` result) misses (see the
    constants): bit equality on (1, 1); else each gap within its gate, or
    within ``SHARDED_NOISE_FACTOR`` times one card's own 2-microbatch gap
    where that was measured."""
    import torch_sharded_checks as checks
    g = out["gaps"]
    if world == 1:
        return [] if g["bit_equal"] else ["bit_equal on (1, 1)"]
    gates = {**RTOL_SHARDED_STEP, "m": RTOL_SHARDED_GRAD,
             "v": RTOL_SHARDED_GRAD, "update": RTOL_SHARDED_UPDATE,
             "flips": RTOL_SHARDED_FLIPS}
    bad = [] if g["lr"] == 0.0 else ["lr"]
    for k, tol in gates.items():
        if "noise_gaps" in out:
            tol = max(tol, SHARDED_NOISE_FACTOR * out["noise_gaps"][k])
        if not g[k] <= tol:
            bad.append(k if k != "update" else
                       f"update (m above {checks.UPDATE_M_SHARE} of max)")
    return bad


def sharded_runs(runs, world: int, mesh, stats) -> None:
    """Phase 32's ``runs`` ({label: ``train_check`` spec}) in one launch of
    ``world`` workers: gates, prints, and the rows into ``stats``."""
    import torch_sharded_checks as checks
    from repro_torch.configs import get_config
    from repro_torch.launch import spmd
    t0 = time.perf_counter()
    try:
        results = spmd.launch(spmd.run_all, world,
                              ([(checks.train_check, r) for r in
                                runs.values()],),
                              device="cuda", timeout=SHARDED_TIMEOUT)[0]
    except (RuntimeError, TimeoutError) as e:
        fail(f"sharded training: {e}")
    print(f"sharded: {len(runs)} runs on {world} worker(s) in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    want = ("flash_attention", "flash_attention_bwd", "ssm_scan",
            "ssm_scan_bwd")
    want_mla = {"flash_attention": 4, "flash_attention_bwd": 2,
                "ssm_scan": 0, "ssm_scan_bwd": 0}
    for (label, spec), out in zip(runs.items(), results):
        if tuple(out["mesh"]) != mesh:
            fail(f"sharded {label}: ran on mesh {out['mesh']}, not {mesh}")
        cfg = get_config(spec["arch"]).replace(**spec.get("overrides", {}))
        warm = float(sorted(r["s"] for r in out["warm_rows"])[0])
        tokens = TRAIN_BATCH * TRAIN_SEQ
        row = {"params": out["params"], "init_s": out["init_s"],
               "first_s": out["rows"][0]["s"], "warm_s": warm,
               "warm_rows_s": [r["s"] for r in out["warm_rows"]],
               "tokens_per_s": tokens / warm,
               "peak_gib": [b / 2**30 for b in out["peak_bytes"]],
               "launches_a_step": out["rows"][0]["launches"],
               "profile": out.get("profile"),
               "lr": [r["lr"] for r in out["rows"]],
               "loss": [r["loss"] for r in out["rows"]],
               "grad_norm": [r["grad_norm"] for r in out["rows"]]}
        if spec["arch"] == "hymba-1.5b":
            if cfg.dtype == "bfloat16":
                flops = model_flops(cfg, TRAIN_BATCH, TRAIN_SEQ)
                row["model_flops"] = flops
                row["mfu"] = flops / warm / (PEAK_BF16_TC * world)
            missing = [k for k in want if not out["rows"][0]["launches"][k]]
            if missing:
                fail(f"sharded {label}: no launch of {missing} in the step "
                     f"({out['rows'][0]['launches']})")
        if spec["arch"] == "deepseek-v3-671b" \
                and out["rows"][0]["launches"] != want_mla:
            fail(f"sharded {label}: launches a step "
                 f"{out['rows'][0]['launches']}, expected {want_mla} (MLA "
                 f"at (192, 128), 2 layers, its heads split over 'model')")
        if "gaps" in out:
            row["gaps"] = out["gaps"]
            if "noise_gaps" in out:
                row["noise_gaps"] = out["noise_gaps"]
            bad = sharded_beyond(out, world)
            if bad:     # every run prints before the phase fails
                stats["beyond_gates"].append((label, bad))
        prof = out.get("profile") or {}
        share = prof.get("nccl_share")
        print(f"sharded {label}: {out['params']:,} parameters, {cfg.dtype}, "
              f"on mesh {mesh}; init {out['init_s']:.2f} s; step "
              f"{row['first_s']:.4f} s first, {warm:.4f} s warm (least of "
              f"{len(out['warm_rows'])}); {tokens / warm:,.0f} tokens/s"
              + (f"; MFU {100 * row['mfu']:.2f} % of {world} x the bf16 "
                 f"dense peak" if "mfu" in row else "")
              + f"; peak GiB a card "
              f"{[round(x, 2) for x in row['peak_gib']]}; NCCL share of "
              f"rank 0's device time "
              + ("not measured" if share is None else f"{100 * share:.2f} %")
              + f"; launches a step {row['launches_a_step']}; lr "
              f"{row['lr']}", flush=True)
        if "gaps" in row:
            print(f"sharded {label} vs one card: {row['gaps']}", flush=True)
        if "noise_gaps" in row:
            print(f"sharded {label}: one card's own 2-microbatch steps vs "
                  f"its whole-batch ones (the noise; gates x "
                  f"{SHARDED_NOISE_FACTOR}): "
                  f"{row['noise_gaps']}", flush=True)
        stats["runs"][label] = row


def analysis_phase(seed: int, t_start: float) -> None:
    """Phase 42: the port's analyzer on the card (see the module
    docstring). ``t_start`` is the run's ``time.time()`` at its start, for
    the process-wide build count."""
    import collections
    import torch
    from repro_torch.analysis import runner
    from repro_torch.analysis.astutil import Project
    from repro_torch.analysis.rules import FAMILIES, family_of
    from repro_torch.analysis.semantic import capture, dt, lg, rc, witness
    dev = torch.device("cuda")
    project = Project(ROOT)
    ast_report = runner.run_analysis(ROOT, with_docs=True, project=project)
    raw = list(ast_report.findings + ast_report.suppressed
               + ast_report.baselined)
    t0 = time.perf_counter()
    static, lg_static = lg.check_static(project)
    card, lg_card = lg.check_card(project, dev, seed)
    print(f"analysis: LG01 {lg_static['profiles']} static profiles "
          f"({lg_static['refused']} refused by a wrapper or launch guard), "
          f"{lg_static['launches']} launches in Hopper's limits; LG02-LG04 "
          f"{lg_card['launches']} guarded launches of {lg_card['profiles']} "
          f"profiles over {lg_card['routes']} routes in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    t0 = time.perf_counter()
    dt_findings = dt.check(project, dev)
    with capture.capture_launches(ROOT) as caps:
        rc_findings = rc.check(project, dev, since=t_start)
    seen = lg.check_routes_seen([(c.library, c.route, c.path, c.line)
                                 for c in caps])
    routes = collections.Counter((c.library, c.route) for c in caps)
    print(f"analysis: DT over {len(dt.ENTRIES)} entries on the card; RC two "
          f"drives, {len(caps)} launches over {len(routes)} routes, "
          f"{rc.build_counts()[0]} libraries built and "
          f"{rc.build_counts()[1]} loaded by this process, in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    report = runner.report_of(
        project, raw + static + card + dt_findings + rc_findings + seen,
        tuple(ast_report.families_run) + runner.SEMANTIC_FAMILIES)
    by_family = collections.Counter(family_of(f.rule)
                                    for f in report.findings)
    for kind, fs in (("active", report.findings),
                     ("noqa", report.suppressed),
                     ("baselined", report.baselined)):
        counts = collections.Counter(family_of(f.rule) for f in fs)
        print(f"analysis: {kind} findings by family: "
              + ", ".join(f"{fam} {counts.get(fam, 0)}" for fam in FAMILIES))
    for f in report.findings:
        print(f"analysis: {f.format()}")
    # the host-sync witness
    t0 = time.perf_counter()
    missing = []
    for name, make in witness.PATHS.items():
        sites = witness.witness_path(ROOT, make, dev)
        top = [f"{rel}:{line} x{n}" for (rel, line), n in
               collections.Counter(sites).most_common(3)]
        print(f"analysis: witness {name}: {len(sites)} syncs, "
              f"{sites.count(witness.OUTSIDE)} with no frame of the port; "
              f"top {top}", flush=True)
        missing += [(name, site) for site in witness.unflagged(project,
                                                                sites)]
    print(f"analysis: witness over {len(witness.PATHS)} paths in "
          f"{time.perf_counter() - t0:.2f} s; {len(missing)} unflagged "
          f"sites", flush=True)
    for name, (rel, line) in missing:
        print(f"analysis: unflagged sync in {name}: {rel}:{line}")
    if report.findings:
        fail(f"analysis: {len(report.findings)} active findings "
             f"({dict(by_family)}): "
             + "; ".join(f.format() for f in report.findings[:10]))
    if missing:
        fail(f"analysis: {len(missing)} card syncs at lines the static HS "
             f"tier does not flag")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, default=0,
                        help="seed of the perturbed kernel rows")
    args = parser.parse_args()
    t_start = time.time()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import numpy as np
    from repro_torch import api, hetero
    from repro_torch.core import bitcells, gainsight, retention
    from repro_torch.core import corners as corners_mod
    from repro_torch.configs import get_config, reduce_config
    from repro_torch.kernels import build, ref
    from repro_torch.kernels import flash_attention as kflash
    from repro_torch.kernels import retention as kretention
    from repro_torch.kernels import ssm_scan as kssm
    from repro_torch.models import LM
    from repro_torch.serve.engine import Engine
    # float32 products in full float32 (the defaults, stated): the plain
    # versions and the card-vs-CPU parity phase need IEEE float32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. device --------------------------------------------------------------
    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    kind, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(f"device: {kind} x{count}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}")
    print(smi, flush=True)
    phase_done(1, "device", t_phase)

    # 2. build ---------------------------------------------------------------
    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    libs = build.build_libraries(KERNELS)     # one nvcc each, all at once
    for name, lib in zip(KERNELS, libs):
        build.load(name)
        print(f"build: {name} -> {lib.name}")
        print(lib.with_suffix(".log").read_text(), flush=True)
    print(f"build: {len(KERNELS)} kernels in {time.perf_counter() - t0:.2f} s",
          flush=True)
    phase_done(2, "build", t_phase)

    # 3. kernel vs plain -----------------------------------------------------
    t_phase = time.perf_counter()
    ts = retention.time_grid(dev)
    base = nominal_rows(dev)
    errs = [compare_kernel(p, ts) for p in
            (base, *(perturbed_rows(base, b, args.seed)
                     for b in (127, 129, 130, 1 << 20)))]
    max_abs_err = max(e[0] for e in errs)
    max_rel_err = max(e[1] for e in errs)
    phase_done(3, "kernel vs plain", t_phase)

    # 4. main path -----------------------------------------------------------
    t_phase = time.perf_counter()
    kretention.retention_batch.launches = 0
    t0 = time.perf_counter()
    report = api.explore(device="cuda")
    torch.cuda.synchronize()
    explore_s = time.perf_counter() - t0
    launches = kretention.retention_batch.launches
    labels = report.labels()
    print(report.summary())
    if labels != gainsight.TABLE2_EXPECTED:
        fail(f"Table 2 on the card: {report.matches(gainsight.TABLE2_EXPECTED)}"
             f"/7, labels {labels}")
    if launches == 0:
        fail("explore(device='cuda') did not launch the retention kernel")
    t0 = time.perf_counter()
    api.explore(device="cuda")
    torch.cuda.synchronize()
    explore_warm_s = time.perf_counter() - t0
    worst = compare_tables("paper grid", report.table,
                           api.DesignTable.build(device="cpu"))
    print(f"main: explore(device='cuda') Table 2 7/7, {launches} kernel "
          f"launch(es), {len(report.table)} configs, card vs CPU max rel "
          f"{worst:.3e}; explore {explore_s:.4f} s first, "
          f"{explore_warm_s:.4f} s warm", flush=True)
    phase_done(4, "main path", t_phase)

    # 5. wide grid -----------------------------------------------------------
    t_phase = time.perf_counter()
    wide = api.design_space(mem_types=tuple(bitcells.BITCELLS),
                            word_sizes=(8, 16, 32, 64, 128, 256),
                            num_words=tuple(2 ** k for k in range(4, 13)),
                            banks=(1, 2, 4, 8), ls_options=(False, True))
    t0 = time.perf_counter()
    wide_table = api.DesignTable.build(wide, device="cuda")
    torch.cuda.synchronize()
    wide_s = time.perf_counter() - t0
    bad = [k for k in wide_table.metric_names
           if not np.isfinite(wide_table[k]).all()]
    if len(wide_table) != 2808 or bad:
        fail(f"wide grid: {len(wide_table)} rows, non-finite columns {bad}")
    print(f"wide: {len(wide_table)} configs characterized on the card in "
          f"{wide_s:.4f} s, all finite", flush=True)
    phase_done(5, "wide grid", t_phase)

    # 6. timing --------------------------------------------------------------
    t_phase = time.perf_counter()
    cells = bitcells.take_bitcell(
        bitcells.stack_bitcells().to(dev),
        torch.tensor([bitcells.MEM_TYPE[m] for m in report.table["mem_type"]],
                     device=dev))
    main_rows = retention.pack_retention_params(
        cells, torch.tensor(report.table["level_shift"], dtype=torch.float32,
                            device=dev))
    shapes = {}
    for label, params, k_iters, p_iters in (
            ("main", main_rows, 200, 3),
            ("2^20", perturbed_rows(base, 1 << 20, args.seed), 20, 2)):
        out = kretention.retention_batch(params, ts)
        ms = time_ms(lambda: kretention.retention_batch(params, ts),
                     k_iters, warmup=3)
        plain_ms = time_ms(lambda: ref.retention_ref(params, ts),
                           p_iters, warmup=1)
        bound_ms, bound_by, terms = bound(params, ts, out)
        shapes[label] = {"B": params.shape[0], "ms": ms,
                         "plain_ms": plain_ms, "bound_ms": bound_ms,
                         "bound_by": bound_by, "bound_terms_ms": terms}
        print(f"timing B={params.shape[0]}: kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}; "
              f"bytes {terms['bytes']:.4f}, operations "
              f"{terms['operations']:.4f}: fp32 alone {terms['fp32']:.4f}, "
              f"SFU alone {terms['sfu']:.4f} ms)", flush=True)
    phase_done(6, "timing", t_phase)

    # 7. where a warm explore's time goes ----------------------------------
    t_phase = time.perf_counter()
    profile_report("warm explore", lambda: api.explore(device="cuda"))
    print(f"end-to-end: explore(device='cuda') {explore_s:.4f} s (first "
          f"call), {explore_warm_s:.4f} s (warm); {smi}", flush=True)
    phase_done(7, "explore profile", t_phase)

    # 8. the serve kernels against their plain versions ---------------------
    t_phase = time.perf_counter()
    attn_err, p_f32 = 0.0, {"max_ulps": 0.0, "max_share": 0.0}
    attn_cases = ([(shape, causal, None, 0) for shape in ATTN_SHAPES
                   for causal in (True, False)]
                  + [(c[:5], True, c[5], c[6]) for c in ATTN_MASK_CASES])
    for shape, causal, window, sink in attn_cases:
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = attn_inputs(shape, dtype, args.seed, dev)
            for round_p in (True, False):
                kw = dict(causal=causal, window=window, sink=sink,
                          round_p=round_p)
                got = kflash.flash_attention(q, k, v, **kw)
                want = ref.attention_ref(q, k, v, **kw)
                torch.cuda.synchronize()
                label = (f"flash_attention {shape} {dtype} causal={causal} "
                         f"window={window} sink={sink} round_p={round_p}")
                if not torch.isfinite(got).all():
                    fail(f"{label}: output not finite")
                err = (got.float() - want.float()).abs().max().item()
                attn_err = max(attn_err, err)
                if dtype == torch.bfloat16 and not round_p:
                    ulps, share = ref.bf16_ulp_gaps(got, want)
                    p_f32["max_ulps"] = max(p_f32["max_ulps"], ulps)
                    p_f32["max_share"] = max(p_f32["max_share"], share)
                    print(f"kernel {label}: max abs err {err:.3e}, "
                          f"{ulps:.3g} ulp, {100 * share:.4f} % of elements "
                          f"differ (gates {MAX_ULPS_P_F32} ulp, "
                          f"{100 * MAX_SHARE_P_F32} %)")
                    if ulps > MAX_ULPS_P_F32 or share > MAX_SHARE_P_F32:
                        fail(f"{label}: {ulps} ulp, share {share}")
                    continue
                tol = TOL_ATTN[str(dtype).split(".")[1]]
                print(f"kernel {label}: max abs err {err:.3e} (tol {tol})")
                if err > tol:
                    fail(f"{label}: max abs err {err:.3e} > {tol}")
    ssm_err = 0.0
    for shape in SSM_SHAPES:
        xs = ssm_inputs(shape, args.seed, dev)
        y, h = kssm.ssm_scan(*xs)
        y_ref, h_ref = ref.ssm_scan_ref(*xs)
        torch.cuda.synchronize()
        errs = [(a - b).abs().max().item() for a, b in ((y, y_ref),
                                                         (h, h_ref))]
        bad = [(a - b).abs() > TOL_SSM * (1 + b.abs())
               for a, b in ((y, y_ref), (h, h_ref))]
        if any(b.any().item() for b in bad):
            fail(f"ssm_scan {shape}: max abs err y {errs[0]:.3e}, h_final "
                 f"{errs[1]:.3e} beyond rtol = atol = {TOL_SSM}")
        ssm_err = max(ssm_err, *errs)
        print(f"kernel ssm_scan {shape}: max abs err y {errs[0]:.3e}, "
              f"h_final {errs[1]:.3e} (rtol = atol = {TOL_SSM})", flush=True)
    phase_done(8, "serve kernels", t_phase)

    # 9. serve hymba-1.5b at full width -------------------------------------
    t_phase = time.perf_counter()
    cfg = get_config("hymba-1.5b")
    t0 = time.perf_counter()
    lm = LM(cfg, device=dev)
    params = lm.init(torch.Generator(device=dev).manual_seed(args.seed))
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in to_leaves(params))
    print(f"serve: {cfg.name} {cfg.num_layers} layers, d_model "
          f"{cfg.d_model}, {n_params / 1e9:.3f} B parameters "
          f"({n_params * 2 / 1e9:.2f} GB bf16), initialized on the card in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    prompt = np.random.default_rng(args.seed).integers(
        0, cfg.vocab_size, (SERVE_REQUESTS, SERVE_PROMPT)).astype(np.int32)
    engine = Engine(cfg, params, max_seq=SERVE_MAX_SEQ, device=dev)
    rec = record_steps(engine)
    serve = {}
    outs = []
    for call in ("first", "warm"):
        kflash.flash_attention.launches = kssm.ssm_scan.launches = 0
        kflash.flash_attention.wg_launches = 0
        kretention.retention_batch.launches = 0
        n_logits = len(rec["logits"])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs.append(engine.generate({"tokens": prompt}, steps=SERVE_STEPS))
        torch.cuda.synchronize()
        total_s = time.perf_counter() - t0
        serve[call] = {
            "generate_s": total_s, "prefill_s": rec["prefill_s"][-1],
            "decode_tok_s": SERVE_REQUESTS * SERVE_STEPS
            / (total_s - rec["prefill_s"][-1]),
            "launches": {"flash_attention": kflash.flash_attention.launches,
                         "ssm_scan": kssm.ssm_scan.launches,
                         "retention": kretention.retention_batch.launches},
            "wg_launches": kflash.flash_attention.wg_launches}
        logits = rec["logits"][n_logits:]
        if not all(torch.isfinite(t).all().item() for t in logits):
            fail(f"serve ({call} call): non-finite logits")
        print(f"serve ({call} call): generate {total_s:.4f} s, prefill "
              f"{serve[call]['prefill_s']:.4f} s, decode "
              f"{serve[call]['decode_tok_s']:.1f} tokens/s, launches "
              f"{serve[call]['launches']}, {len(logits)} logit sets finite",
              flush=True)
    serve_launches = serve["first"]["launches"]
    # the attention launches on flash_kernel_wg: all, where the forward
    # routes hymba's heads there
    serve_wg = cfg.num_layers if kflash.forward_kernel(
        cfg.head_dim, cfg.head_dim, torch.bfloat16) == "flash_kernel_wg" \
        else 0
    if serve_launches["flash_attention"] != cfg.num_layers or \
            serve_launches["ssm_scan"] != cfg.num_layers or \
            serve["first"]["wg_launches"] != serve_wg:
        fail(f"serve launches {serve_launches}, "
             f"{serve['first']['wg_launches']} on flash_kernel_wg; expected "
             f"{cfg.num_layers} flash_attention ({len(cfg.full_attn_every)} "
             f"global, {cfg.num_layers - len(cfg.full_attn_every)} "
             f"sliding-window; {serve_wg} on flash_kernel_wg) and "
             f"{cfg.num_layers} ssm_scan")
    print(f"serve: {serve['first']['wg_launches']} of the "
          f"{serve_launches['flash_attention']} attention launches a "
          f"generate on flash_kernel_wg (expected {serve_wg})", flush=True)
    if not np.array_equal(outs[0], outs[1]) or outs[0].shape != (
            SERVE_REQUESTS, SERVE_STEPS):
        fail("serve: two generate calls gave different tokens")
    # decode vs prefill at this width, the depth cut to 1..32 layers, in
    # float32 and bf16, with weights drawn from --seed: rounding carried
    # through the random-weight layers grows with depth, while a cache fault
    # shows at any depth. Gated where rounding cannot hide a fault (float32,
    # <= 2 layers: one global-attention and one SWA layer, the ring wrapping
    # during the 32 steps); the rest is printed.
    toks = np.concatenate([prompt, outs[0]], axis=1)
    for dtype in ("float32", "bfloat16"):
        for depth in (1, 2, 4, 8, 16, 32):
            dcfg = cfg.replace(dtype=dtype, num_layers=depth,
                               full_attn_every=(0,) if depth <= 2 else
                               (0, depth // 2 - 1, depth - 1))
            dlm = LM(dcfg, dev)
            gap, scale, agree = decode_vs_prefill(
                dlm, dlm.init(torch.Generator(device=dev).manual_seed(
                    args.seed)), toks, SERVE_PROMPT, SERVE_MAX_SEQ)
            gated = dtype == "float32" and depth <= 2
            print(f"serve: decode vs prefill, {depth} layers {dtype}, "
                  f"{SERVE_STEPS} steps: max abs {gap:.4e} of max |logit| "
                  f"{scale:.4e} ({gap / scale:.3e}), argmax agreement "
                  f"{agree:.2f}" + (f" (gate {RTOL_DECODE_PREFILL})"
                                    if gated else " (not gated)"),
                  flush=True)
            if gated and (gap > RTOL_DECODE_PREFILL * scale or agree < 1):
                fail(f"decode vs prefill at full width, {depth} layers "
                     f"float32: {gap / scale:.3e} > {RTOL_DECODE_PREFILL}")
    phase_done(9, "serve", t_phase)

    # 10. reduced hymba: the card against the CPU ---------------------------
    t_phase = time.perf_counter()
    reduced_card_vs_cpu(reduce_config(cfg), args.seed)
    phase_done(10, "parity", t_phase)

    # 11. timing of the serve kernels ---------------------------------------
    t_phase = time.perf_counter()
    B, H, K, D = (SERVE_REQUESTS, cfg.num_heads, cfg.num_kv_heads,
                  cfg.head_dim)
    S = cfg.meta_tokens + SERVE_PROMPT
    q, k, v = attn_inputs((B, H, K, S, D), torch.bfloat16, args.seed, dev)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    attn_lib_ms = time_ms(lambda: sdpa(q, k, v, is_causal=True,
                                       enable_gqa=True), 20, 3)
    attn_timing = {}
    for label, kw in (
            ("causal, p rounded", dict(round_p=True)),
            ("causal, p float32", dict(round_p=False)),
            ("SWA, p float32", dict(window=cfg.window, sink=cfg.meta_tokens,
                                    round_p=False))):
        b_ms, b_by = attn_bound(B, H, K, S, D, 2, kw.get("window"),
                                kw.get("sink", 0))
        attn_timing[label] = {
            "ms": time_ms(lambda: kflash.flash_attention(q, k, v, **kw),
                          50, 5),
            "plain_ms": time_ms(lambda: ref.attention_ref(q, k, v, **kw),
                                10, 2),
            "bound_ms": b_ms, "bound_by": b_by}
        t = attn_timing[label]
        print(f"timing flash_attention {(B, H, K, S, D)} bf16 {label}: "
              f"kernel {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, SDPA "
              f"(causal, GQA; the mask is the same at this S) "
              f"{attn_lib_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})",
              flush=True)
    main_attn = attn_timing["SWA, p float32"]
    di, n = cfg.d_model * cfg.ssm_expand, cfg.ssm_state
    xs = ssm_inputs((B, S, di, n), args.seed, dev)
    ssm_ms = time_ms(lambda: kssm.ssm_scan(*xs), 20, 3)
    ssm_plain_ms = time_ms(lambda: ref.ssm_scan_ref(*xs), 3, 1)
    ssm_bound_ms, ssm_bound_by, ssm_terms = ssm_bound(B, S, di, n)
    print(f"timing ssm_scan {(B, S, di, n)}: kernel {ssm_ms:.4f} ms, plain "
          f"{ssm_plain_ms:.4f} ms, bound {ssm_bound_ms:.4f} ms "
          f"({ssm_bound_by}; bytes {ssm_terms['bytes']:.4f}, operations "
          f"{ssm_terms['operations']:.4f}: fp32 alone "
          f"{ssm_terms['fp32']:.4f}, SFU alone {ssm_terms['sfu']:.4f} ms); "
          f"no single PyTorch call computes the scan", flush=True)
    phase_done(11, "serve kernel timing", t_phase)

    # 12. where serve time goes ---------------------------------------------
    t_phase = time.perf_counter()
    with torch.inference_mode():
        box = {}

        def prefill():
            box["cache"], box["logits"] = lm.prefill(
                params, {"tokens": prompt}, max_seq=SERVE_MAX_SEQ)
        prof = profile_report("prefill", prefill)
        for label, key in (("attention", "flash_kernel"),
                           ("scan", "ssm_scan_kernel")):
            own = [e for e in prof["kernels"] if key in e.key]
            own_ms = sum(e.self_device_time_total for e in own) / 1e3
            print(f"profile: prefill {label} kernel {own_ms:.4f} ms in "
                  f"{sum(e.count for e in own)} launches, "
                  f"{device_share(own_ms, prof['device_ms'])} of the "
                  f"device time", flush=True)
        tok = {"tokens": box["logits"].argmax(-1)}
        lm.decode(params, box["cache"], tok)            # warm the step
        profile_report("warm decode step",
                       lambda: lm.decode(params, box["cache"], tok))
    phase_done(12, "serve profile", t_phase)

    # 13. the retention kernel at the other operating corners -------------
    t_phase = time.perf_counter()
    main_ls = torch.tensor(report.table["level_shift"], dtype=torch.float32,
                           device=dev)
    gain_cell = torch.tensor(report.table["mem_type"] != "sram6t",
                             device=dev)
    nominal_main = kretention.retention_batch(main_rows, ts)
    wide_cells = bitcells.take_bitcell(
        bitcells.stack_bitcells().to(dev),
        torch.tensor([bitcells.MEM_TYPE[m] for m in wide_table["mem_type"]],
                     device=dev))
    wide_ls = torch.tensor(wide_table["level_shift"], dtype=torch.float32,
                           device=dev)
    wide_nominal = retention.pack_retention_params(wide_cells, wide_ls)
    ms_wide_nominal = time_ms(
        lambda: kretention.retention_batch(wide_nominal, ts), 100, warmup=3)
    wide_bound_ms, wide_bound_by, _ = bound(
        wide_nominal, ts, kretention.retention_batch(wide_nominal, ts))
    shapes["wide"] = {"B": wide_nominal.shape[0], "ms": ms_wide_nominal,
                      "bound_ms": wide_bound_ms, "bound_by": wide_bound_by}
    print(f"timing B={wide_nominal.shape[0]} (the wide grid): kernel "
          f"{ms_wide_nominal:.4f} ms, bound {wide_bound_ms:.3e} ms "
          f"({wide_bound_by})", flush=True)
    corner_kernel, corner_errs = {}, []
    for op in KERNEL_CORNERS:
        point = corners_mod.as_operating_point(op)
        tp = corners_mod.TechParams.from_op(point)
        rows = retention.pack_retention_params(cells, main_ls, tp)
        base_c = torch.cat([retention.pack_retention_params(
            bitcells.stack_bitcells().to(dev),
            torch.full((7,), float(ls), device=dev), tp) for ls in (0, 1)])
        big = perturbed_rows(base_c, 1 << 20, args.seed)
        c_errs = [compare_kernel(r, ts, tp.ut, point.corner) for r in
                  (rows, perturbed_rows(base_c, 127, args.seed),
                   perturbed_rows(base_c, 129, args.seed), big)]
        out = kretention.retention_batch(rows, ts, tp.ut)
        if point.corner == "hot" and not bool(
                (out[gain_cell] < nominal_main[gain_cell]).all()):
            fail("hot-corner retention is not below nominal for every "
                 "gain-cell row of the paper grid: ut did not reach the "
                 "kernel")
        ms_main = time_ms(lambda: kretention.retention_batch(rows, ts,
                                                             tp.ut),
                          200, warmup=3)
        wide_rows = retention.pack_retention_params(wide_cells, wide_ls, tp)
        c_errs.append(compare_kernel(wide_rows, ts, tp.ut, point.corner))
        ms_wide = time_ms(lambda: kretention.retention_batch(wide_rows, ts,
                                                             tp.ut),
                          100, warmup=3)
        ms_big = time_ms(lambda: kretention.retention_batch(big, ts, tp.ut),
                         20, warmup=2)
        corner_errs += c_errs
        corner_kernel[point.corner] = {
            "ut": tp.ut, "ms_B120": ms_main, "ms_B2808": ms_wide,
            "ms_B2^20": ms_big, "max_rel_err": max(e[1] for e in c_errs)}
        print(f"timing at {point.corner} (ut {tp.ut:.6g} V): kernel "
              f"{ms_main:.4f} ms at B={rows.shape[0]}, {ms_wide:.4f} ms at "
              f"B={wide_rows.shape[0]}, {ms_big:.4f} ms at B=2^20 (nominal "
              f"{shapes['main']['ms']:.4f}, {ms_wide_nominal:.4f} and "
              f"{shapes['2^20']['ms']:.4f} ms)", flush=True)
    max_abs_err = max(max_abs_err, *(e[0] for e in corner_errs))
    max_rel_err = max(max_rel_err, *(e[1] for e in corner_errs))
    phase_done(13, "retention kernel at corners", t_phase)

    # 14. corner tables and robust explore -----------------------------------
    t_phase = time.perf_counter()
    named = tuple(corners_mod.CORNERS)
    corner_tables = {}
    for name, space in (("paper", None), ("wide", wide)):
        walls = []
        for _ in ("first", "warm"):
            kretention.retention_batch.launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rob = api.explore(space, corners=named, robust="worst_case",
                              device="cuda")
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            n_launch = kretention.retention_batch.launches
            if n_launch != len(named):
                fail(f"{name} grid at corners {named}: {n_launch} retention "
                     f"launches, expected {len(named)}")
        cpu_rob = api.explore(space, corners=named, robust="worst_case",
                              device="cpu")
        worst = compare_tables(f"{name} grid at corners", rob.table,
                               cpu_rob.table)
        if rob.labels() != cpu_rob.labels() or \
                picks_of(rob.selections) != picks_of(cpu_rob.selections):
            fail(f"{name} grid: robust explore labels or picks differ "
                 f"between card and CPU")
        corner_tables[name] = {"configs": len(rob.table),
                               "launches": n_launch, "first_s": walls[0],
                               "warm_s": walls[1], "max_rel_vs_cpu": worst}
        print(f"table: {name} grid, {len(rob.table)} configs at "
              f"{list(rob.table.corner_labels)}: {n_launch} retention "
              f"launches a build, card vs CPU max rel {worst:.3e}, robust "
              f"labels and picks equal to the CPU's; explore(corners, "
              f"robust) {walls[0]:.4f} s first, {walls[1]:.4f} s warm",
              flush=True)
    phase_done(14, "corner tables", t_phase)

    # 15. compose against the goldens ---------------------------------------
    t_phase = time.perf_counter()
    golden = {name: json.loads((ROOT / "tests" / "golden" / name)
                               .read_text())
              for name in ("table2_nlevel.json", "table2_vdd.json")}
    ptable = api.DesignTable.build(device="cuda")

    def timed_compose(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rep = hetero.compose(*args, device="cuda", **kwargs)
        torch.cuda.synchronize()
        return rep, time.perf_counter() - t0

    t2_walls, t2 = [], 0
    for t in gainsight.TASKS:
        rep, wall = timed_compose(ptable, t)
        t2_walls.append(wall)
        t2 += rep.labels() == gainsight.TABLE2_EXPECTED[t.task_id]
    if t2 != len(gainsight.TASKS):
        fail(f"Table 2 through compose on the card: {t2}/7")
    print(f"compose: Table 2 through compose on the card {t2}/7; a compose "
          f"{t2_walls[0]:.4f} s first, {min(t2_walls[1:]):.4f}-"
          f"{max(t2_walls[1:]):.4f} s after", flush=True)
    compose_stats = {"table2": f"{t2}/7", "table2_s": t2_walls}
    for name, kw in NLEVEL_POLICIES.items():
        want = golden["table2_nlevel.json"]["compositions"][name]
        n_evals = hetero.composition_eval_count()
        rep, wall = timed_compose(ptable, gainsight.nlevel_task(3),
                                  compose_policy=hetero.ComposePolicy(**kw))
        _, wall_warm = timed_compose(ptable, gainsight.nlevel_task(3),
                                     compose_policy=hetero.ComposePolicy(**kw))
        best = rep.best
        got = {"labels": best.labels(),
               "picks": {lvl: [p.config_idx for p in lc.picks]
                         for lvl, lc in best.levels.items()},
               "tiles": {lvl: list(lc.tiles)
                         for lvl, lc in best.levels.items()},
               "n_space": rep.n_space, "search": rep.search}
        bad = [k for k in got if got[k] != want[k]]
        rel = max(abs(best.metrics[k] - v) / abs(v)
                  for k, v in want["metrics"].items())
        if bad or rel > RTOL_GOLDEN:
            fail(f"N-level golden {name} on the card: fields {bad} differ, "
                 f"metrics max rel {rel:.3e} (gate {RTOL_GOLDEN})")
        compose_stats[name] = {
            "n_scored": rep.n_compositions, "n_space": rep.n_space,
            "dispatches": (hetero.composition_eval_count() - n_evals) // 2,
            "metrics_max_rel": rel, "first_s": wall, "warm_s": wall_warm}
        print(f"compose: nlevel3 {name} on the card: labels, picks, tiles, "
              f"n_space {rep.n_space} and search {rep.search} as the golden, "
              f"metrics max rel {rel:.3e}; {rep.n_compositions} compositions "
              f"scored in {compose_stats[name]['dispatches']} dispatch(es); "
              f"{wall:.4f} s first, {wall_warm:.4f} s warm", flush=True)
    swept_policy = hetero.ComposePolicy(vdd_sweep=(VDD_SWEEP_POINT,))
    vdd = golden["table2_vdd.json"]
    flipped, walls, sweep_launches = [], [], []
    for t in gainsight.TASKS:
        want = vdd["tasks"][str(t.task_id)]
        base = hetero.compose(ptable, t, device="cuda")
        for _ in ("first", "warm") if t.task_id == 1 else ("first",):
            kretention.retention_batch.launches = 0
            n_evals = hetero.composition_eval_count()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            swept = hetero.compose(ptable, t, compose_policy=swept_policy,
                                   device="cuda")
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            sweep_launches.append(kretention.retention_batch.launches)
            sweep_dispatches = hetero.composition_eval_count() - n_evals
        picks = {lvl: [[p.family, p.config_idx,
                        p.op.corner if p.op is not None else None,
                        p.refresh_margin] for p in lc.picks]
                 for lvl, lc in swept.best.levels.items()}
        rel = max(abs(r.best.metrics["p_w"] - want["p_w"][k])
                  / want["p_w"][k] for k, r in (("base", base),
                                                ("swept", swept)))
        if base.labels() != want["base_labels"] or \
                swept.labels() != want["swept_labels"] or \
                picks != want["picks"] or rel > RTOL_GOLDEN:
            fail(f"vdd golden, task {t.task_id}, on the card: labels "
                 f"{base.labels()} -> {swept.labels()}, picks {picks}, p_w "
                 f"max rel {rel:.3e}")
        if swept.labels() != base.labels():
            flipped.append(t.task_id)
    if flipped != [1, 2, 4, 6] or set(sweep_launches) != {1}:
        fail(f"vdd sweep on the card: flips {flipped} (golden [1, 2, 4, 6]), "
             f"retention launches per swept compose {sweep_launches}")
    compose_stats["vdd_sweep"] = {"flipped": flipped,
                                  "launches_per_compose": sweep_launches[0],
                                  "dispatches": sweep_dispatches,
                                  "first_s": walls[0], "warm_s": walls[1]}
    print(f"compose: vdd sweep to {VDD_SWEEP_POINT} on the card flips tasks "
          f"{flipped} as the golden, picks and p_w as the golden; "
          f"{sweep_launches[0]} retention launch and {sweep_dispatches} "
          f"scoring dispatch a swept compose; swept "
          f"compose {walls[0]:.4f} s first, {walls[1]:.4f} s warm "
          f"(tasks 2-7: {min(walls[2:]):.4f}-{max(walls[2:]):.4f} s)",
          flush=True)
    prof = profile_report("warm swept compose", lambda: hetero.compose(
        ptable, gainsight.TASKS[0], compose_policy=swept_policy,
        device="cuda"))
    compose_stats["profile"] = {k: prof[k] for k in
                                ("wall_s", "device_ms", "launches")}
    phase_done(15, "compose", t_phase)

    # 16. simulate: the trace-replay re-rank ----------------------------------
    t_phase = time.perf_counter()
    sim_stats, sim_launches = simulate_phase(ptable, args.seed)
    phase_done(16, "simulate", t_phase)

    # 17. the façade: Compiler.compile, Macro.write_all, gradient_size ------
    t_phase = time.perf_counter()
    facade, compile_launches = facade_phase()
    phase_done(17, "facade", t_phase)

    # 18. telemetry, the sanitizer and the device grid ----------------------
    t_phase = time.perf_counter()
    launches_by_path = {
        "explore": launches,
        **{f"explore_corners_{k}": v["launches"]
           for k, v in corner_tables.items()},
        "compose_vdd_sweep": compose_stats["vdd_sweep"][
            "launches_per_compose"],
        "simulate": sim_launches,
        "compiler_compile": compile_launches}
    observability = observability_phase(ptable, cfg, params, prompt,
                                         launches_by_path, args.seed)
    phase_done(18, "telemetry, sanitizer, grid", t_phase)
    del engine, params
    torch.cuda.empty_cache()

    # 19. the backward kernels against their plain versions -----------------
    t_phase = time.perf_counter()
    bwd = backward_kernels_phase(args.seed)
    phase_done(19, "backward kernels", t_phase)

    # 20. train hymba-1.5b at full width -------------------------------------
    t_phase = time.perf_counter()
    train = training_phase(args.seed, smi)
    phase_done(20, "train", t_phase)

    # 21. training on the card against the CPU, and the supervisor ----------
    t_phase = time.perf_counter()
    train_parity = training_parity_phase(args.seed)
    phase_done(21, "train parity, supervisor", t_phase)

    # 22. the flash-attention kernel at the MoE family's shapes -------------
    t_phase = time.perf_counter()
    moe_kernels = attention_shapes_phase(MOE_ATTN_SHAPES, 4, args.seed)
    phase_done(22, "MoE-family attention", t_phase)

    # 23-24. serve moonshot-v1-16b-a3b and deepseek-v3-671b at full width --
    moe_serve = {}
    for phase_no, (arch, n_layers) in enumerate(MOE_SERVE, start=23):
        t_phase = time.perf_counter()
        moe_serve[arch] = serve_full_phase(arch, n_layers, args.seed)
        phase_done(phase_no, f"serve {arch}", t_phase)

    # 25. the reduced MoE models on the card against the CPU ----------------
    t_phase = time.perf_counter()
    moe_parity = {}
    for arch, _ in MOE_SERVE:
        rcfg = reduce_config(get_config(arch))
        serve_gap = reduced_card_vs_cpu(rcfg, args.seed)
        loss_gap, grad_gap, bwd_launches = train_card_vs_cpu(rcfg, args.seed)
        attn_layers = rcfg.num_layers + int(rcfg.mtp)   # MTP's layer too
        if bwd_launches != {"flash_attention_bwd": attn_layers,
                            "ssm_scan_bwd": 0}:
            fail(f"reduced {arch} training on the card: backward launches "
                 f"{bwd_launches}, expected {attn_layers} of the attention "
                 f"backward")
        moe_parity[arch] = {"serve": serve_gap, "loss": loss_gap,
                            "grads": grad_gap, "bwd_launches": bwd_launches}
    phase_done(25, "MoE parity", t_phase)

    # 26. the flash-attention kernel at the vision and audio prefill -------
    t_phase = time.perf_counter()
    family_kernels = attention_shapes_phase(FAMILY_ATTN_SHAPES, 2, args.seed)
    phase_done(26, "vision and audio attention", t_phase)

    # 27-29. serve phi-3-vision-4.2b, musicgen-medium and xlstm-125m -------
    family_serve = {}
    for phase_no, arch in enumerate(FAMILY_SERVE, start=27):
        t_phase = time.perf_counter()
        family_serve[arch] = serve_full_phase(arch, None, args.seed)
        phase_done(phase_no, f"serve {arch}", t_phase)

    # 30. the reduced families on the card against the CPU ----------------
    t_phase = time.perf_counter()
    family_parity = {}
    for arch in FAMILY_SERVE:
        rcfg = reduce_config(get_config(arch))
        serve_gap = reduced_card_vs_cpu(rcfg, args.seed)
        loss_gap, grad_gap, bwd_launches = train_card_vs_cpu(rcfg, args.seed)
        attn_layers = 0 if rcfg.family == "ssm" else rcfg.num_layers
        if bwd_launches != {"flash_attention_bwd": attn_layers,
                            "ssm_scan_bwd": 0}:
            fail(f"reduced {arch} training on the card: backward launches "
                 f"{bwd_launches}, expected {attn_layers} of the attention "
                 f"backward")
        family_parity[arch] = {"serve": serve_gap, "loss": loss_gap,
                               "grads": grad_gap,
                               "bwd_launches": bwd_launches}
    phase_done(30, "vision, audio and xLSTM parity", t_phase)

    # 31. requirements from models: records, roofline, explore, simulate --
    t_phase = time.perf_counter()
    requirements = requirements_phase(smi)
    launches_by_path["explore_arch_tasks"] = requirements["launches"]
    phase_done(31, "requirements from models", t_phase)

    # 32. sharded training on every visible card -------------------------------
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    sharded = sharded_phase(args.seed, smi)
    sharded_launches = sharded["runs"]["hymba-1.5b"]["launches_a_step"]
    phase_done(32, "sharded training", t_phase)

    # 33. train deepseek-v3 (MLA) at full width, 2 dense layers ------------
    t_phase = time.perf_counter()
    train_mla = training_phase(args.seed, smi, *TRAIN_MLA,
                               steps=TRAIN_MLA_STEPS)
    phase_done(33, "train deepseek", t_phase)

    # 34. the flash-attention kernel at the dense family's prefill --------
    t_phase = time.perf_counter()
    dense_kernels = attention_shapes_phase(DENSE_ATTN_SHAPES,
                                           len(DENSE_ATTN_SHAPES), args.seed)
    phase_done(34, "dense-family attention", t_phase)

    # 35-38. serve granite-34b, qwen3-32b, qwen3-8b and internlm2-1.8b ----
    dense_serve = {}
    for phase_no, arch in enumerate(DENSE_SERVE, start=35):
        t_phase = time.perf_counter()
        dense_serve[arch] = serve_full_phase(arch, None, args.seed)
        phase_done(phase_no, f"serve {arch}", t_phase)

    # 39. the reduced dense models on the card against the CPU -------------
    t_phase = time.perf_counter()
    dense_parity = {}
    for arch in DENSE_SERVE:
        rcfg = reduce_config(get_config(arch))
        noise = serve_noise(rcfg, args.seed)
        gate = max(RTOL_SERVE_CPU, SERVE_NOISE_FACTOR * noise)
        print(f"parity: reduced {arch}'s own float32 noise on the card "
              f"(weights moved by half an ulp) {noise:.3e}: gate "
              f"{gate:.3e}", flush=True)
        serve_gap = reduced_card_vs_cpu(rcfg, args.seed, gate)
        loss_gap, grad_gap, bwd_launches = train_card_vs_cpu(rcfg, args.seed)
        if bwd_launches != {"flash_attention_bwd": rcfg.num_layers,
                            "ssm_scan_bwd": 0}:
            fail(f"reduced {arch} training on the card: backward launches "
                 f"{bwd_launches}, expected {rcfg.num_layers} of the "
                 f"attention backward")
        dense_parity[arch] = {"serve": serve_gap, "serve_noise": noise,
                              "serve_gate": gate, "loss": loss_gap,
                              "grads": grad_gap, "bwd_launches": bwd_launches}
    phase_done(39, "dense parity", t_phase)

    # 40. train internlm2-1.8b at full width and depth ----------------------
    t_phase = time.perf_counter()
    train_dense = training_phase(args.seed, smi, TRAIN_DENSE,
                                 steps=TRAIN_DENSE_STEPS)
    phase_done(40, f"train {TRAIN_DENSE}", t_phase)

    # 41. the smoke script and the examples ---------------------------------
    t_phase = time.perf_counter()
    examples = examples_phase()
    launches_by_path.update({
        f"example_{k}": examples[f"torch_{k}"]["launches"]["retention"]
        for k in ("quickstart", "heterogeneous_dse")})
    phase_done(41, "smoke script and examples", t_phase)

    # 42. the analyzer ------------------------------------------------------
    t_phase = time.perf_counter()
    analysis_phase(args.seed, t_start)
    phase_done(42, "analysis", t_phase)

    # 43. train phi-3-vision-4.2b at full width and depth -------------------
    t_phase = time.perf_counter()
    train_vision = training_phase(args.seed, smi, TRAIN_VISION,
                                  steps=TRAIN_VISION_STEPS)
    vcfg = get_config(TRAIN_VISION)
    off = [r["bwd_wg_launches"] for r in train_vision["steps"]
           if r["bwd_wg_launches"] != vcfg.num_layers
           or r["wg_launches"] != 2 * vcfg.num_layers]
    if train_vision["params"] != TRAIN_VISION_PARAMS or off:
        fail(f"{TRAIN_VISION} training: {train_vision['params']:,} "
             f"parameters (want {TRAIN_VISION_PARAMS:,}), steps whose "
             f"backward launches were not all on wgmma: {off}")
    phase_done(43, f"train {TRAIN_VISION}", t_phase)

    main_shape = shapes["main"]
    wg_main = moe_kernels["timing"][str(MOE_ATTN_SHAPES[0])]
    warm = serve["warm"]
    print(f"end-to-end: serve {cfg.name} {SERVE_REQUESTS} x {SERVE_PROMPT} "
          f"tokens + {SERVE_STEPS} steps: prefill "
          f"{serve['first']['prefill_s']:.4f} s first, {warm['prefill_s']:.4f}"
          f" s warm; decode {serve['first']['decode_tok_s']:.1f} tokens/s "
          f"first, {warm['decode_tok_s']:.1f} tokens/s warm; {smi}")
    for arch, st in {**moe_serve, **family_serve, **dense_serve}.items():
        print(f"end-to-end: serve {arch} ({st['layers']} layers) "
              f"{SERVE_REQUESTS} x {SERVE_PROMPT} tokens + {SERVE_STEPS} "
              f"steps: prefill {st['first']['prefill_s']:.4f} s first, "
              f"{st['warm']['prefill_s']:.4f} s warm; decode "
              f"{st['warm']['decode_tok_s']:.1f} tokens/s warm; peak "
              f"{st['warm']['peak_gib']:.2f} GiB; {smi}")
    print(json.dumps({"kernels": [{
        "name": "retention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/retention.cu",
        "replaces": "src/repro/kernels/retention_kernel.py:68",
        "launches": launches, "max_abs_err": max_abs_err,
        "max_rel_err": max_rel_err, "rtol": RTOL_KERNEL,
        "ms": main_shape["ms"], "plain_ms": main_shape["plain_ms"],
        "bound_ms": main_shape["bound_ms"],
        "bound_by": main_shape["bound_by"], "library_ms": None,
        "bound_terms_ms": main_shape["bound_terms_ms"], "shapes": shapes,
        "launches_by_path": launches_by_path,
        "corners": corner_kernel, "corner_tables": corner_tables,
        "compose": compose_stats, "simulate": sim_stats,
        "facade": facade, "observability": observability,
        "requirements": requirements}, {
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:68",
        "launches": serve_launches["flash_attention"],
        "max_abs_err": attn_err, "tol": TOL_ATTN,
        "p_float32_bf16": {**p_f32, "gate_ulps": MAX_ULPS_P_F32,
                           "gate_share": MAX_SHARE_P_F32},
        "ms": main_attn["ms"], "plain_ms": main_attn["plain_ms"],
        "bound_ms": main_attn["bound_ms"],
        "bound_by": main_attn["bound_by"], "library_ms": attn_lib_ms,
        "shape": [B, H, K, S, D], "window": cfg.window,
        "sink": cfg.meta_tokens, "modes": attn_timing,
        "train_launches": train["launches"]["flash_attention"],
        "sharded_train_launches": sharded_launches["flash_attention"],
        "launches_by_path": {
            "serve_hymba": serve_launches["flash_attention"],
            "train_hymba_step": train["launches"]["flash_attention"],
            **{f"serve_{arch}": st["first"]["launches"]
               for arch, st in {**moe_serve, **family_serve,
                                **dense_serve}.items()},
            f"train_{TRAIN_DENSE}_step":
                train_dense["steps"][0]["launches"]["flash_attention"],
            f"train_{TRAIN_VISION}_step":
                train_vision["steps"][0]["launches"]["flash_attention"],
            **{f"example_{k}": v["launches"]["flash_attention"]
               for k, v in examples.items()}},
        "moe_family": {"kernel_checks": moe_kernels, "serve": moe_serve,
                       "reduced_card_vs_cpu": moe_parity,
                       "rtol_card_vs_cpu": RTOL_SERVE_CPU},
        "vision_audio_xlstm": {"kernel_checks": family_kernels,
                               "serve": family_serve,
                               "reduced_card_vs_cpu": family_parity,
                               "rtol_train_card_vs_cpu": RTOL_TRAIN_CPU},
        "dense_family": {"kernel_checks": dense_kernels,
                         "serve": dense_serve,
                         "reduced_card_vs_cpu": dense_parity,
                         "rtol_train_card_vs_cpu": RTOL_TRAIN_CPU},
        "examples": examples}, {
        "name": "flash_attention_wg", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:68",
        "instantiation": "flash_kernel_wg<64, 64>, <96, 96>, <128, 128>, "
                         "<192, 128> (bf16, wgmma, two consumer warpgroups "
                         "and a producer a block; D = 96 on three 32-column "
                         "slabs in the 64-byte swizzle), both treatments "
                         "of p",
        "launches": serve["first"]["wg_launches"]
        + sum(st["first"]["wg_launches"]
              for st in {**moe_serve, **family_serve,
                         **dense_serve}.values()),
        "max_abs_err": moe_kernels["wg_max_abs_err"], "tol": TOL_ATTN,
        **{k: wg_main[k] for k in ("ms", "ms_round_p", "plain_ms",
                                   "bound_ms", "bound_by", "library_ms")},
        "shape": list(MOE_ATTN_SHAPES[0]), "timing": moe_kernels["timing"],
        "registers": moe_kernels["registers"],
        "ptxas_notes": moe_kernels["ptxas_notes"],
        "dense_timing": dense_kernels["timing"],
        "family_timing": family_kernels["timing"],
        "launches_by_path": {
            "serve_hymba": serve["first"]["wg_launches"],
            **{f"serve_{arch}": st["first"]["wg_launches"]
               for arch, st in {**moe_serve, **family_serve,
                                **dense_serve}.items()},
            "train_hymba_step": train["steps"][0]["wg_launches"],
            "train_deepseek_step": train_mla["steps"][0]["wg_launches"],
            f"train_{TRAIN_DENSE}_step":
                train_dense["steps"][0]["wg_launches"],
            f"train_{TRAIN_VISION}_step":
                train_vision["steps"][0]["wg_launches"]}}, {
        "name": "ssm_scan", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ssm_scan.cu",
        "replaces": "src/repro/kernels/ssm_scan.py:50",
        "launches": serve_launches["ssm_scan"], "max_abs_err": ssm_err,
        "tol": TOL_SSM, "ms": ssm_ms, "plain_ms": ssm_plain_ms,
        "bound_ms": ssm_bound_ms, "bound_by": ssm_bound_by,
        "library_ms": None, "bound_terms_ms": ssm_terms,
        "shape": [B, S, di, n],
        "launches_by_path": {
            "serve_hymba": serve_launches["ssm_scan"],
            "train_hymba_step": train["launches"]["ssm_scan"],
            **{f"example_{k}": v["launches"]["ssm_scan"]
               for k, v in examples.items()}},
        "train_launches": train["launches"]["ssm_scan"],
        "sharded_train_launches": sharded_launches["ssm_scan"]}, {
        "name": "flash_attention_bwd", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
        "replaces": "src/repro/models/attention.py:110",
        "gradient_of": "causal_attention, by autodiff in the JAX model; the "
                       "TPU kernel src/repro/kernels/flash_attention.py:68 "
                       "is forward only",
        "instantiation": "bf16: dkdv_kernel_wg<64, 64> / dq_kernel_wg<64, "
                         "64> (hymba, wgmma, one warpgroup a block), "
                         "dkdv_kernel_wg2<128, 128> / dq_kernel_wg2<128, "
                         "128> (the dense family, moonshot) and <96, 96> "
                         "(phi-3-vision; three 32-column slabs a row in the "
                         "64-byte swizzle) on wgmma, two warpgroups a "
                         "block, dkdv_kernel_tc / dq_kernel_tc (mma.sync) "
                         "at the reduced configs' pairs; the float32 pair",
        "launches": train["launches"]["flash_attention_bwd"],
        "max_abs_err": max(c["max_abs_err"]
                           for c in bwd["flash_attention_bwd"]["cases"]),
        "max_rel_err": bwd["flash_attention_bwd"]["max_rel_err"],
        "rtol": RTOL_ATTN_BWD, "cases": bwd["flash_attention_bwd"]["cases"],
        "ms": bwd["flash_attention_bwd"]["SWA"]["ms"],
        "plain_ms": bwd["flash_attention_bwd"]["SWA"]["plain_ms"],
        "bound_ms": bwd["flash_attention_bwd"]["SWA"]["bound_ms"],
        "bound_by": bwd["flash_attention_bwd"]["SWA"]["bound_by"],
        "library_ms": bwd["flash_attention_bwd"]["SWA"]["library_ms"],
        **{k: bwd["flash_attention_bwd"]["SWA"][k] for k in (
            "library", "unqueued_ms", "stages_ms")},
        "global": bwd["flash_attention_bwd"]["global"],
        "internlm2": bwd["flash_attention_bwd"]["internlm2"],
        "moonshot": bwd["flash_attention_bwd"]["moonshot"],
        "phi": bwd["flash_attention_bwd"]["phi"],
        **{k: bwd["flash_attention_bwd"][k] for k in (
            "registers_128", "ptxas_notes_128", "registers_96",
            "ptxas_notes_96")},
        "wgmma_launches_by_path": {
            "train_hymba_step": train["steps"][0]["bwd_wg_launches"],
            f"train_{TRAIN_DENSE}_step": train_dense["steps"][0][
                "bwd_wg_launches"],
            f"train_{TRAIN_VISION}_step": train_vision["steps"][0][
                "bwd_wg_launches"]},
        "launches_by_path": {
            "train_hymba_step": train["launches"]["flash_attention_bwd"],
            f"train_{TRAIN_DENSE}_step": train_dense["steps"][0][
                "launches"]["flash_attention_bwd"],
            f"train_{TRAIN_VISION}_step": train_vision["steps"][0][
                "launches"]["flash_attention_bwd"],
            **{f"train_{a}_reduced": p["bwd_launches"]["flash_attention_bwd"]
               for a, p in dense_parity.items()},
            "example_train_lm": examples["torch_train_lm"]["launches"][
                "flash_attention_bwd"]},
        "train_dense": train_dense, "train_vision": train_vision,
        "shape": [B, H, K, S, D], "train": train,
        "sharded_train_launches": sharded_launches["flash_attention_bwd"],
        "sharded": sharded}, {
        "name": "ssm_scan_bwd", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ssm_scan_bwd.cu",
        "replaces": "src/repro/models/ssm.py:78",
        "gradient_of": "ssm_scan_chunked, by autodiff in the JAX model; the "
                       "TPU kernel src/repro/kernels/ssm_scan.py:50 is "
                       "forward only",
        "launches": train["launches"]["ssm_scan_bwd"],
        "max_abs_err": max(c["max_abs_err"]
                           for c in bwd["ssm_scan_bwd"]["cases"]),
        "max_rel_err": bwd["ssm_scan_bwd"]["max_rel_err"],
        "rtol": RTOL_SSM_BWD, "cases": bwd["ssm_scan_bwd"]["cases"],
        **{k: bwd["ssm_scan_bwd"][k] for k in (
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "bound_terms_ms", "unqueued_ms", "stages_ms", "shape")},
        "train_parity": train_parity,
        "sharded_train_launches": sharded_launches["ssm_scan_bwd"]}, {
        "name": "flash_attention_bwd_mla", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
        "replaces": "src/repro/models/mla.py:69",
        "instantiation": "dkdv_kernel_wg2<192, 128>, dq_kernel_wg2<192, "
                         "128> (bf16, wgmma, two warpgroups a block); the "
                         "float32 pair and <32, 16>",
        "gradient_of": "causal_attention at MLA's head dims (query/key "
                       "192, value 128), by autodiff in the JAX model",
        "launches": train_mla["launches"]["flash_attention_bwd"],
        "max_abs_err": max(c["max_abs_err"]
                           for c in bwd["flash_attention_bwd_mla"]["cases"]),
        "max_rel_err": bwd["flash_attention_bwd_mla"]["max_rel_err"],
        "rtol": RTOL_ATTN_BWD,
        "cases": bwd["flash_attention_bwd_mla"]["cases"],
        **{k: bwd["flash_attention_bwd_mla"][k] for k in (
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "library", "shape", "profile")},
        "train": train_mla}]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
