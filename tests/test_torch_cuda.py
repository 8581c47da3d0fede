"""Card-only checks of the PyTorch port: each CUDA kernel (retention at
every operating corner, selective scan, flash attention with its window,
sink and both treatments of p, and the two backward kernels) against its
plain version on the card, and
the corner table, ``compose``, the trace-replay re-rank (``simulate``) and
the compiler façade (``Compiler.compile``, ``Macro.write_all``,
``gradient_size``) and ``explore`` over the models' dry-run tasks on the
card against the CPU. They skip
where no CUDA device is present;
on a GPU machine run them with ``python -m pytest -m cuda tests/``. This
file imports no jax, so it also runs where jax is not installed."""
import numpy as np
import pytest
import torch

from repro_torch import api
from repro_torch.core import bitcells, corners, gainsight, retention
from repro_torch.hetero import ComposePolicy, compose
from repro_torch import sim
from repro_torch.core.select import Bucket, LevelReq, TaskReq
from repro_torch.sim.rerank import composition_idx, sim_cols
from repro_torch.kernels import flash_attention as kflash
from repro_torch.kernels import ref
from repro_torch.kernels import retention as kretention
from repro_torch.kernels import ssm_scan as kssm

RTOL_KERNEL = 1e-5      # the reference's gate for its Pallas kernel
# a table on the card vs the same table on the CPU (chip_smoke.py's gate)
RTOL_CPU = 2e-6
# the replayed sim_* metrics on the card against the CPU (chip_smoke.py's
# gate), and the 200-step sizing on the card against the CPU
RTOL_SIM = 1e-5
RTOL_GRAD = 1e-4
# the corners of the corner slice: the named ones and the vdd sweep's
# cold-boost point
CORNERS = ("hot", "cold", "low_vdd", (1.2, 233.0))
# the reference's gates for its flash-attention and selective-scan kernels
# (tests/test_kernels.py), held here between each kernel and its plain
# version on the card
TOL_ATTN = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
TOL_SSM = 1e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc: the kernel has no CPU "
                    "mode")
    return torch.device("cuda")


def _nominal():
    """The 14 packed nominal rows: 7 bitcells x level shifter."""
    cells = bitcells.stack_bitcells()
    return torch.cat([retention.pack_retention_params(
        cells, torch.full((7,), float(ls))) for ls in (0, 1)]).numpy()


def _perturbed(n, seed=0):
    """``n`` rows drawn from the nominal ones: log-uniform factors in
    [0.1, 10] on ispec, i_floor, c_sn and w, vt shifted by +-50 mV."""
    base = _nominal().astype(np.float64)
    rng = np.random.default_rng(seed)
    p = base[rng.integers(0, len(base), n)]
    for field in (2, 4, 6, 7):
        p[:, field] *= 10.0 ** rng.uniform(-1.0, 1.0, n)
    p[:, 0] += rng.uniform(-0.05, 0.05, n)
    return p.astype(np.float32)


def _stiff():
    """Tiny storage caps and large gate leaks: RK4 overshoots, so the [0, 2]
    clip of V decides the crossing time."""
    base = _nominal()[7 + bitcells.MEM_TYPE["gc_sisi"]]
    rows = []
    for c_sn in (1e-18, 3e-18, 1e-17, 1e-16):
        for jg in (1e-9, 1e-7, 1e-5):
            rows.append(base.copy())
            rows[-1][6], rows[-1][5] = c_sn, jg
    return np.asarray(rows, np.float32)


# 127 and 129 rows: either side of the kernel's 128-row block
ROWS = {"nominal-14": _nominal, "perturbed-127": lambda: _perturbed(127),
        "perturbed-129": lambda: _perturbed(129),
        "perturbed-130": lambda: _perturbed(130),
        "perturbed-4097": lambda: _perturbed(4097), "stiff-12": _stiff}


@pytest.mark.cuda
@pytest.mark.parametrize("rows", sorted(ROWS))
def test_kernel_matches_plain_version_on_the_card(cuda, rows):
    params = torch.from_numpy(ROWS[rows]()).to(cuda)
    ts = retention.time_grid(cuda)
    before = kretention.retention_batch.launches
    got = kretention.retention_batch(params, ts)
    want = ref.retention_ref(params, ts)
    torch.cuda.synchronize()
    assert kretention.retention_batch.launches == before + 1
    torch.testing.assert_close(got, want, rtol=RTOL_KERNEL, atol=0)
    start = params[:, 8] < params[:, 9]
    assert torch.equal(got[start], want[start])


@pytest.mark.cuda
def test_kernel_takes_a_grid_beyond_48_kb_of_shared_memory(cuda):
    """A 4,097-point grid: ts and each step's dt, dt / 2 and dt / 6 take
    64 KB of shared memory, which the launch opts in to."""
    params = torch.from_numpy(_perturbed(130, 1)).to(cuda)
    ts = torch.logspace(-9, 7, 4097, device=cuda)
    got = kretention.retention_batch(params, ts)
    want = ref.retention_ref(params, ts)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=RTOL_KERNEL, atol=0)


@pytest.mark.cuda
def test_main_path_retention_goes_through_the_kernel(cuda):
    cells = bitcells.stack_bitcells().to(cuda)
    ls = torch.ones(7, device=cuda)
    before = kretention.retention_batch.launches
    got = retention.retention_time_batch(cells, ls)
    torch.cuda.synchronize()
    assert kretention.retention_batch.launches == before + 1
    want = retention.retention_time_batch(cells.to("cpu"), ls.cpu())
    torch.testing.assert_close(got.cpu(), want, rtol=RTOL_KERNEL, atol=0)


def _corner_rows(op, device):
    """The paper grid's packed rows at ``op``, and its TechParams."""
    tp = corners.resolve(corners.as_operating_point(op))
    space = api.design_space()
    cells = bitcells.take_bitcell(bitcells.stack_bitcells(), torch.tensor(
        [bitcells.MEM_TYPE[c.mem_type] for c in space])).to(device)
    ls = torch.tensor([float(c.level_shift) for c in space], device=device)
    return retention.pack_retention_params(cells, ls, tp), tp


@pytest.mark.cuda
@pytest.mark.parametrize("op", CORNERS, ids=str)
def test_kernel_takes_the_thermal_voltage_at_each_corner(cuda, op):
    """The paper grid's rows at the corner and 129 perturbed rows, against
    the plain version at the corner's ut; at hot every gain-cell row
    retains for less time than at nominal."""
    params, tp = _corner_rows(op, cuda)
    perturbed = torch.from_numpy(_perturbed(129, 7)).to(cuda)
    ts = retention.time_grid(cuda)
    for rows in (params, perturbed):
        before = kretention.retention_batch.launches
        got = kretention.retention_batch(rows, ts, tp.ut)
        want = ref.retention_ref(rows, ts, tp.ut)
        torch.cuda.synchronize()
        assert kretention.retention_batch.launches == before + 1
        torch.testing.assert_close(got, want, rtol=RTOL_KERNEL, atol=0)
        start = rows[:, 8] < rows[:, 9]
        assert torch.equal(got[start], want[start])
    if op == "hot":
        nominal, _ = _corner_rows("nominal", cuda)
        gc = torch.tensor([c.mem_type != "sram6t"
                           for c in api.design_space()], device=cuda)
        hot = kretention.retention_batch(params, ts, tp.ut)
        nom = kretention.retention_batch(nominal, ts)
        assert (hot[gc] < nom[gc]).all()


@pytest.mark.cuda
def test_corner_table_and_robust_explore_match_the_cpu(cuda):
    """The paper grid at the four named corners: 4 retention launches,
    columns within RTOL_CPU of the CPU build, robust explore labels and
    picks equal."""
    named = tuple(corners.CORNERS)
    before = kretention.retention_batch.launches
    card = api.DesignTable.build(corners=named, device=cuda)
    assert kretention.retention_batch.launches == before + len(named)
    cpu = api.DesignTable.build(corners=named, device="cpu")
    for k in cpu.metric_names:
        np.testing.assert_allclose(card[k], cpu[k], rtol=RTOL_CPU, atol=0,
                                   err_msg=k)
    got = api.explore(card, robust="worst_case", device=cuda)
    want = api.explore(cpu, robust="worst_case", device="cpu")
    assert got.labels() == want.labels()
    assert [[(p.family, p.config_idx) for p in sel.picks]
            for lv in got.selections.values() for sel in lv.values()] == \
        [[(p.family, p.config_idx) for p in sel.picks]
         for lv in want.selections.values() for sel in lv.values()]


@pytest.mark.cuda
@pytest.mark.parametrize("policy", [
    dict(), dict(objective="power", candidate_mode="all_feasible",
                 search="branch_and_bound"),
    dict(vdd_sweep=((1.2, 233.0),))], ids=["preference", "power_bb", "vdd"])
def test_compose_on_the_card_matches_the_cpu(cuda, policy):
    """The N-level reference task (and, swept, the Table-2 tasks) composed
    on the card: labels, picks, tiles, n_space and search equal to the
    CPU's; a vdd-swept compose launches the retention kernel once."""
    tasks = ([gainsight.nlevel_task(3)] if "vdd_sweep" not in policy
             else gainsight.TASKS)
    card_table = api.DesignTable.build(device=cuda)
    cpu_table = api.DesignTable.build(device="cpu")
    for t in tasks:
        before = kretention.retention_batch.launches
        got = compose(card_table, t, compose_policy=ComposePolicy(**policy),
                      device=cuda)
        assert kretention.retention_batch.launches == \
            before + ("vdd_sweep" in policy)
        want = compose(cpu_table, t, compose_policy=ComposePolicy(**policy),
                       device="cpu")
        assert (got.n_space, got.search, got.n_compositions) == \
            (want.n_space, want.search, want.n_compositions)
        for a, b in zip(got.ranked, want.ranked):
            assert a.labels() == b.labels()
            assert {n: ([(p.family, p.config_idx, p.op) for p in lc.picks],
                        lc.tiles) for n, lc in a.levels.items()} == \
                {n: ([(p.family, p.config_idx, p.op) for p in lc.picks],
                     lc.tiles) for n, lc in b.levels.items()}
            for k, v in b.metrics.items():
                np.testing.assert_allclose(a.metrics[k], v, rtol=RTOL_CPU)


def _sim_rel(got, want):
    """Worst relative gap over the finite sim_* metrics (infs in the same
    places)."""
    worst = 0.0
    for m in sim.SIM_METRICS:
        a, b = np.asarray(got[m]), np.asarray(want[m])
        np.testing.assert_array_equal(np.isfinite(a), np.isfinite(b))
        fin = np.isfinite(b) & (b != 0)
        np.testing.assert_array_equal(a[~fin], b[~fin])
        if fin.any():
            worst = max(worst, float(np.max(np.abs(a[fin] - b[fin])
                                            / np.abs(b[fin]))))
    return worst


@pytest.mark.cuda
@pytest.mark.parametrize("objective", ["preference", "power"])
def test_simulate_on_the_card_matches_the_cpu(cuda, objective):
    """``compose(refine="simulate")`` on the card: the Table-2 tasks (7/7)
    or the 3-level task under power, re-rank order equal to the CPU's on
    the same table, sim metrics within RTOL_SIM."""
    table = api.DesignTable.build(device=cuda)
    tasks = gainsight.TASKS if objective == "preference" \
        else [gainsight.nlevel_task(3)]
    kw = dict(compose_policy=ComposePolicy(objective=objective),
              sim_policy=sim.SimPolicy(objective="energy"), refine="simulate")
    for t in tasks:
        n = sim.sim_eval_count()
        got = compose(table, t, device=cuda, **kw)
        assert sim.sim_eval_count() == n + 1
        want = compose(table, t, device="cpu", **kw)
        if objective == "preference":
            assert got.labels() == gainsight.TABLE2_EXPECTED[t.task_id]
        np.testing.assert_array_equal(composition_idx(got),
                                      composition_idx(want))
        rel = _sim_rel(
            {m: [c.metrics[f"sim_{m}"] for c in got.ranked]
             for m in sim.SIM_METRICS},
            {m: [c.metrics[f"sim_{m}"] for c in want.ranked]
             for m in sim.SIM_METRICS})
        assert rel <= RTOL_SIM


@pytest.mark.cuda
@pytest.mark.parametrize("policy", [
    dict(), dict(adaptive_refresh=True, temp_drift_k=30.0),
    dict(refresh=False)], ids=["default", "adaptive-drift", "expiry"])
def test_simulate_traces_on_the_card_matches_the_cpu(cuda, policy):
    """4,096 random compositions x 4 slots x 3 phases with sentinels."""
    table = api.DesignTable.build(device="cpu")
    rng = np.random.default_rng(5)
    idx = rng.integers(0, len(table), (4096, 4)).astype(np.int32)
    idx[rng.random(idx.shape) < 0.01] = -1
    task = TaskReq("x", "x", {
        "L1": LevelReq("L1", 1 << 20, (Bucket(0.6, 1.2e9, 2e-6),
                                       Bucket(0.4, 5e8, 1e-4))),
        "L2": LevelReq("L2", 64 << 20, (Bucket(0.5, 1e9, 1e-3),
                                        Bucket(0.5, 2e9, 3e-6)))})
    traces = sim.task_traces(task, ("prefill", "decode", "train_step"))
    kw = dict(policy=sim.SimPolicy(**policy))
    got = sim.simulate_traces(sim_cols(table), idx, traces, device=cuda, **kw)
    want = sim.simulate_traces(sim_cols(table), idx, traces, device="cpu",
                               **kw)
    assert _sim_rel(got, want) <= RTOL_SIM
    for phase in want["phases"]:
        assert _sim_rel(got["phases"][phase], want["phases"][phase]) \
            <= RTOL_SIM


@pytest.mark.cuda
def test_cached_simulate_runs_no_replay_and_no_kernel(cuda, tmp_path):
    task = gainsight.TASKS[2]
    before = kretention.retention_batch.launches
    first = api.simulate(task=task, cache=tmp_path, device=cuda)
    assert kretention.retention_batch.launches == before + 1
    counts = (sim.sim_eval_count(), api.characterize_call_count(),
              kretention.retention_batch.launches)
    again = api.simulate(task=task, cache=tmp_path, device=cuda)
    assert (sim.sim_eval_count(), api.characterize_call_count(),
            kretention.retention_batch.launches) == counts
    assert [c.metrics for c in again.ranked] == \
        [c.metrics for c in first.ranked]


@pytest.mark.cuda
def test_compiler_on_the_card_matches_the_cpu(cuda, tmp_path):
    """One retention launch a compile, PPA within RTOL_CPU of the CPU's,
    the emitted files byte-equal (the .v and .lib given the same PPA), DRC
    and LVS clean, and the sizing within RTOL_GRAD."""
    kw = dict(mem_type="gc_ossi", word_size=64, num_words=128)
    before = kretention.retention_batch.launches
    card = api.Compiler().compile(**kw)
    assert kretention.retention_batch.launches == before + 1
    cpu = api.Compiler(device="cpu").compile(**kw)
    for k, v in cpu.ppa.items():
        np.testing.assert_allclose(card.ppa[k], v, rtol=RTOL_CPU, err_msg=k)
    rep = card.write_all(tmp_path / "card")
    api.Macro(config=card.config, ppa=cpu.ppa).write_all(tmp_path / "same")
    cpu.write_all(tmp_path / "cpu")
    assert rep["drc_clean"] and rep["lvs_clean"]
    for ext, src in (("sp", "card"), ("lef", "card"), ("v", "same"),
                     ("lib", "same")):
        name = f"{card.name}.{ext}"
        assert (tmp_path / src / name).read_bytes() == \
            (tmp_path / "cpu" / name).read_bytes(), ext
    cfg = api.MacroConfig(**kw)
    got = api.Compiler().gradient_size(cfg)
    want = api.Compiler(device="cpu").gradient_size(cfg)
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=RTOL_GRAD, err_msg=k)


# (B, H, K, S, D): the reference's shapes (tests/test_kernels.py), a ragged
# S, GQA, and hymba-1.5b's full-width prefill (25 q heads on 5 kv heads,
# 128 meta tokens + a 1,000-token prompt)
ATTN_SHAPES = [(1, 2, 2, 256, 64), (2, 1, 1, 128, 128), (1, 4, 4, 512, 64),
               (2, 2, 2, 256, 96), (2, 4, 4, 200, 64), (1, 6, 2, 77, 32),
               (4, 25, 5, 1128, 64)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ATTN_SHAPES, ids=str)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_flash_attention_kernel_matches_plain_version(cuda, shape, dtype,
                                                      causal):
    B, H, K, S, D = shape
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.normal(size=(B, h, S, D)).astype(
        np.float32)).to(cuda, dtype) for h in (H, K, K))
    before = kflash.flash_attention.launches
    got = kflash.flash_attention(q, k, v, causal=causal)
    want = ref.attention_ref(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert kflash.flash_attention.launches == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    tol = TOL_ATTN[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


# (B, H, K, S, D, window, sink): GQA, ragged S, a window with a sink that no
# tile boundary meets, a window >= S, hymba-1.5b's serving prefill (window
# 1,024 and 128 meta tokens: the mask equals the causal one at S = 1,128),
# and a longer prompt where the window cuts, so that tiles are skipped
ATTN_MASK_CASES = [(1, 6, 2, 77, 32, None, 0), (2, 4, 1, 200, 64, None, 0),
                   (1, 4, 2, 300, 64, 100, 20), (2, 2, 2, 517, 128, 128, 70),
                   (1, 4, 4, 256, 16, 1000, 16), (1, 5, 5, 190, 96, 64, 0),
                   (4, 25, 5, 1128, 64, 1024, 128),
                   (1, 25, 5, 2176, 64, 1024, 128)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", ATTN_MASK_CASES, ids=str)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("round_p", [True, False], ids=["p-rounded", "p-f32"])
def test_flash_attention_kernel_window_sink_and_p_modes(cuda, case, dtype,
                                                        round_p):
    """Both treatments of p, with window and sink: float32 and bf16 with p
    rounded at the reference's gates, bf16 with p in float32 within one bf16
    ulp per element and at most 1 % of the elements differing."""
    B, H, K, S, D, window, sink = case
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(rng.normal(size=(B, h, S, D)).astype(
        np.float32)).to(cuda, dtype) for h in (H, K, K))
    before = kflash.flash_attention.launches
    got = kflash.flash_attention(q, k, v, window=window, sink=sink,
                                 round_p=round_p)
    want = ref.attention_ref(q, k, v, window=window, sink=sink,
                             round_p=round_p)
    torch.cuda.synchronize()
    assert kflash.flash_attention.launches == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    if dtype == torch.bfloat16 and not round_p:
        ulps, share = ref.bf16_ulp_gaps(got, want)
        assert ulps <= 1.0 and share <= 0.01, (ulps, share)
    else:
        tol = TOL_ATTN[dtype]
        torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                   atol=tol)


# (B, H, K, S, D, Dv, causal, window, sink) of the bf16 forward's wgmma
# kernel (flash_kernel_wg, at (64, 64), (96, 96), (128, 128) and MLA's
# (192, 128)): moonshot-v1-16b-a3b's and deepseek-v3's prefill, the D = 128
# window and sink case of chip_smoke.py's ATTN_MASK_CASES, ragged S (333,
# 517; one row; one past a 64-row half), granite-34b's MQA (48 q heads on
# one kv head; at its serving prefill of 4 x 1,000 too), GQA, and keys and
# queries apart without a causal mask; at D = 96 (three 32-column slabs)
# and 64 (one slab): phi-3-vision-4.2b's and musicgen-medium's prefill,
# hymba-1.5b's with its window of 1,024 and 128 meta tokens and without
# (ragged S 1,128; 25 q heads on 5 kv heads), a longer hymba prompt where
# the window cuts and tiles are skipped, ragged S (65, 333, 517), one row,
# GQA at 96, a window at 96, and keys and queries apart
WG_CASES = [(4, 32, 32, 1000, 96, 96, True, None, 0),
            (4, 24, 24, 1000, 64, 64, True, None, 0),
            (4, 25, 5, 1128, 64, 64, True, 1024, 128),
            (4, 25, 5, 1128, 64, 64, True, None, 0),
            (1, 25, 5, 2176, 64, 64, True, 1024, 128),
            (1, 2, 2, 65, 96, 96, True, None, 0),
            (1, 4, 4, 65, 64, 64, True, None, 0),
            (2, 4, 2, 333, 96, 96, True, None, 0),
            (1, 16, 16, 333, 64, 64, True, None, 0),
            (1, 4, 4, 517, 96, 96, True, None, 0),
            (2, 4, 2, 517, 64, 64, True, None, 0),
            (1, 2, 2, 1, 96, 96, True, None, 0),
            (1, 2, 2, 1, 64, 64, True, None, 0),
            (2, 6, 2, 300, 96, 96, True, None, 0),
            (1, 5, 5, 190, 96, 96, True, 64, 0),
            (2, 6, 3, 300, 96, 96, False, None, 0),
            (2, 4, 2, 200, 64, 64, False, None, 0),
            (4, 16, 16, 1000, 128, 128, True, None, 0),
            (4, 128, 128, 1000, 192, 128, True, None, 0),
            (2, 6, 2, 517, 128, 128, True, 128, 70),
            (1, 16, 16, 333, 192, 128, True, None, 0),
            (2, 4, 2, 333, 128, 128, True, None, 0),
            (1, 4, 4, 517, 192, 128, True, None, 0),
            (2, 4, 2, 517, 128, 128, True, None, 0),
            (1, 2, 2, 1, 192, 128, True, None, 0),
            (1, 2, 2, 65, 128, 128, True, None, 0),
            (1, 48, 1, 512, 128, 128, True, None, 0),
            (4, 48, 1, 1000, 128, 128, True, None, 0),
            (2, 6, 3, 300, 192, 128, False, None, 0)]
# the row log-sum-exps against plain torch's: fp32 sums of 2^x taken with
# ex2.approx (relative error ~2^-22 an exponential) in another order
ATOL_LSE = 1e-4


def _wg_inputs(cuda, case, seed=5):
    B, H, K, S, D, Dv = case[:6]
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.normal(size=(B, h, S, d)).astype(
        np.float32)).to(cuda, torch.bfloat16)
        for h, d in ((H, D), (K, D), (K, Dv)))


@pytest.mark.cuda
@pytest.mark.parametrize("case", WG_CASES, ids=str)
@pytest.mark.parametrize("round_p", [True, False], ids=["p-rounded", "p-f32"])
def test_wgmma_forward_matches_plain_version(cuda, case, round_p):
    """One launch, on flash_kernel_wg, within phase 8's gates of the plain
    version (p rounded: TOL_ATTN; p in float32: 1 bf16 ulp, at most 1 % of
    the elements apart), and bit-equal over two runs."""
    causal, window, sink = case[6:]
    q, k, v = _wg_inputs(cuda, case)
    kw = dict(causal=causal, window=window, sink=sink, round_p=round_p)
    before = (kflash.flash_attention.launches,
              kflash.flash_attention.wg_launches)
    got = kflash.flash_attention(q, k, v, **kw)
    again = kflash.flash_attention(q, k, v, **kw)
    want = ref.attention_ref(q, k, v, **kw)
    torch.cuda.synchronize()
    assert (kflash.flash_attention.launches,
            kflash.flash_attention.wg_launches) == (before[0] + 2,
                                                    before[1] + 2)
    assert got.shape == q.shape[:3] + v.shape[3:]
    assert torch.equal(got, again)
    if round_p:
        tol = TOL_ATTN[torch.bfloat16]
        torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                   atol=tol)
    else:
        ulps, share = ref.bf16_ulp_gaps(got, want)
        assert ulps <= 1.0 and share <= 0.01, (ulps, share)


@pytest.mark.cuda
def test_wgmma_forward_runs_without_spills(cuda):
    """bf16 (64, 64), (96, 96), (128, 128) and (192, 128) name
    flash_kernel_wg, and the built library's ``-Xptxas -v`` report holds
    its eight instantiations (four pairs, both treatments of p) with no
    spill store and no mma.sync forward at those pairs."""
    import re
    from repro_torch.kernels import build
    pairs = ((64, 64), (96, 96), (128, 128), (192, 128))
    assert all(kflash.forward_kernel(D, Dv, torch.bfloat16)
               == "flash_kernel_wg" for D, Dv in pairs)
    log = build.build_library("flash_attention").with_suffix(
        ".log").read_text()
    spills, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            k = re.search(r"flash_kernel_(wg|tc)ILi(\d+)ELi(\d+)ELb([01])E",
                          m[1])
            name = None if k is None else (k[1], int(k[2]), int(k[3]), k[4])
            continue
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and name:
            spills[name] = int(m[1])
    assert {n: s for n, s in spills.items() if n[0] == "wg"} == {
        ("wg", D, Dv, p): 0 for D, Dv in pairs for p in "01"}, spills
    assert not [n for n in spills if n[0] == "tc" and n[1:3] in pairs]


@pytest.mark.cuda
@pytest.mark.parametrize("case", WG_CASES, ids=str)
def test_wgmma_forward_lse_matches_plain_logsumexp(cuda, case):
    """The training call's row log-sum-exps (what the backward recomputes p
    from) against torch.logsumexp of the scaled, masked float32 scores."""
    import math
    causal, window, sink = case[6:]
    q, k, v = _wg_inputs(cuda, case)
    o, lse = kflash._forward(q, k, v, causal, window, sink, False,
                             with_lse=True)
    G = q.shape[1] // k.shape[1]
    s = (q.float() @ k.float().repeat_interleave(G, 1).transpose(-1, -2)) \
        / math.sqrt(q.shape[-1])
    if causal:
        r = torch.arange(s.shape[-2], device=cuda)[:, None]
        c = torch.arange(s.shape[-1], device=cuda)[None]
        vis = c <= r
        if window is not None:
            vis &= (r - c < window) | (c < sink)
        s = s.masked_fill(~vis, -math.inf)
    want = torch.logsumexp(s, -1)
    assert torch.isfinite(lse).all()
    assert (lse - want).abs().max().item() <= ATOL_LSE
    assert torch.equal(o, kflash.flash_attention(
        q, k, v, causal=causal, window=window, sink=sink, round_p=False))


# (B, S, di, n): the reference's shapes, a di that no block divides,
# hymba-1.5b's full width (di = 2 * 1600, n = 16, S = 128 + 1,000), n = 4
# and 32 (the other instantiations), S = 1, B = 1 at hymba's di, and S one
# past a 32-step staging round
SSM_SHAPES = [(1, 128, 256, 16), (2, 256, 512, 8), (1, 64, 1024, 16),
              (2, 45, 200, 8), (4, 1128, 3200, 16), (2, 100, 384, 4),
              (1, 70, 256, 32), (3, 1, 3200, 16), (1, 1128, 3200, 16),
              (2, 33, 200, 16)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SSM_SHAPES, ids=str)
def test_ssm_scan_kernel_matches_plain_version(cuda, shape):
    B, S, di, n = shape
    rng = np.random.default_rng(2)

    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(cuda)

    x = t(rng.normal(size=(B, S, di)))
    dt = t(rng.uniform(0.001, 0.1, size=(B, S, di)))
    A = t(-rng.uniform(0.5, 2.0, size=(di, n)))
    Bc, Cc = t(rng.normal(size=(B, S, n))), t(rng.normal(size=(B, S, n)))
    D = t(rng.normal(size=(di,)))
    before = kssm.ssm_scan.launches
    y, h = kssm.ssm_scan(x, dt, A, Bc, Cc, D)
    y_ref, h_ref = ref.ssm_scan_ref(x, dt, A, Bc, Cc, D)
    torch.cuda.synchronize()
    assert kssm.ssm_scan.launches == before + 1
    torch.testing.assert_close(y, y_ref, rtol=TOL_SSM, atol=TOL_SSM)
    torch.testing.assert_close(h, h_ref, rtol=TOL_SSM, atol=TOL_SSM)


# the backward kernels against autograd of their plain versions, as
# max|kernel - plain| / max|plain| per gradient: bf16 attention (both round
# dQ, dK, dV to bf16 at the end; the kernel takes Delta from the bf16 o),
# fp32 attention (summation order), the fp32 scan (summation order over up
# to B S terms)
RTOL_ATTN_BWD = {torch.float32: 2e-5, torch.bfloat16: 1e-2}
RTOL_SSM_BWD = 1e-4

# (B, H, K, S, D, window, sink): GQA, ragged S, a window with a sink no tile
# boundary meets, D = 16 (the reduced hymba) and 128, in both dtypes;
# hymba-1.5b's training shapes (the 29 sliding-window layers and the 3
# global ones) in bf16, the model's dtype; and the dense family's bf16
# (128, 128) backward (dkdv_kernel_wg2 / dq_kernel_wg2) with two query
# heads a kv head on a ragged S and at granite-34b's 48 on one (MQA: the
# dK/dV combine sums 48 heads' partials)
_SMALL = [(1, 6, 2, 77, 32, None, 0), (2, 4, 4, 200, 64, None, 0),
          (1, 4, 2, 300, 64, 100, 20), (2, 2, 1, 130, 128, 64, 0),
          (2, 4, 2, 44, 16, 16, 4)]
ATTN_BWD_CASES = [(c, dt) for c in _SMALL
                  for dt in (torch.float32, torch.bfloat16)] + [
    ((4, 25, 5, 1128, 64, 1024, 128), torch.bfloat16),
    ((4, 25, 5, 1128, 64, None, 0), torch.bfloat16),
    ((2, 4, 2, 333, 128, None, 0), torch.bfloat16),
    ((1, 48, 1, 256, 128, None, 0), torch.bfloat16)]


def _rel_gaps(got, want):
    return [((g.float() - w.float()).abs().max()
             / w.float().abs().max()).item() for g, w in zip(got, want)]


@pytest.mark.cuda
@pytest.mark.parametrize("case,dtype", ATTN_BWD_CASES, ids=str)
def test_flash_attention_bwd_kernel_matches_plain_gradients(cuda, case,
                                                            dtype):
    """The backward kernel through the autograd wrapper (one launch a
    backward) against autograd of ``attention_ref`` with p in float32."""
    B, H, K, S, D, window, sink = case
    rng = np.random.default_rng(5)
    q, k, v, do = (torch.from_numpy(rng.normal(size=(B, h, S, D)).astype(
        np.float32)).to(cuda, dtype) for h in (H, K, K, H))
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    before = (kflash.flash_attention.launches,
              kflash.flash_attention_bwd.launches)
    o = kflash.flash_attention(*leaves, window=window, sink=sink,
                               round_p=False)
    got = torch.autograd.grad(o, leaves, do)
    torch.cuda.synchronize()
    assert (kflash.flash_attention.launches,
            kflash.flash_attention_bwd.launches) == (before[0] + 1,
                                                     before[1] + 1)
    want = ref.attention_ref_grads(q, k, v, do, window=window, sink=sink)
    gaps = _rel_gaps(got, want)
    assert all(g.dtype == dtype for g in got)
    assert max(gaps) <= RTOL_ATTN_BWD[dtype], gaps


@pytest.mark.cuda
def test_flash_attention_on_the_card_refuses_to_train_with_p_rounded(cuda):
    q = torch.ones((1, 2, 8, 16), device=cuda, requires_grad=True)
    with pytest.raises(ValueError, match="round_p=False"):
        kflash.flash_attention(q, q, q)


# (B, H, K, S, Dqk, Dv): deepseek-v3's MLA (query/key 192, value 128) at
# its serving prompt and on a ragged S, the reduced MLA's 24 / 16 (the
# wrapper pads q and k to 32) with a ragged S, and the MoE and dense
# families' other new shapes: moonshot-v1-16b-a3b's prefill and
# granite-34b's MQA
MLA_CASES = [(4, 128, 128, 1000, 192, 128), (1, 16, 16, 333, 192, 128),
             (2, 4, 4, 40, 24, 16), (3, 4, 4, 77, 24, 16),
             (4, 16, 16, 1000, 128, 128), (1, 48, 1, 512, 128, 128)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", MLA_CASES, ids=str)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("round_p", [True, False], ids=["p-rounded", "p-f32"])
def test_flash_attention_kernel_takes_mla_head_dims(cuda, case, dtype,
                                                    round_p):
    """A value head dim apart from the query/key one, and a query/key dim
    padded to the kernel's: one launch, output (B, H, S, Dv), the gates of
    ``test_flash_attention_kernel_window_sink_and_p_modes``."""
    _check_causal_case(cuda, case, dtype, round_p)


# (B, H, K, S, D): phi-3-vision-4.2b's prefill (576 patches + 424 text
# tokens; 32 heads of 96) and musicgen-medium's (1,000 frames; 24 heads of
# 64), and a ragged S at each head dim
FAMILY_ATTN_CASES = [(4, 32, 32, 1000, 96), (4, 24, 24, 1000, 64),
                     (1, 32, 32, 589, 96), (2, 24, 24, 77, 64)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", FAMILY_ATTN_CASES, ids=str)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("round_p", [True, False], ids=["p-rounded", "p-f32"])
def test_flash_attention_kernel_at_the_vision_and_audio_prefill(
        cuda, case, dtype, round_p):
    """The vision and audio families' prefill calls: the gates of
    ``test_flash_attention_kernel_takes_mla_head_dims``."""
    _check_causal_case(cuda, case + (case[-1],), dtype, round_p)


def _check_causal_case(cuda, case, dtype, round_p):
    """Causal attention at (B, H, K, S, D, Dv): one launch, output (B, H, S,
    Dv), within ``TOL_ATTN`` of the plain version (bf16 with p in float32:
    within 1 bf16 ulp, at most 1 % of the elements apart)."""
    B, H, K, S, D, Dv = case
    rng = np.random.default_rng(4)
    q, k, v = (torch.from_numpy(rng.normal(size=(B, h, S, d)).astype(
        np.float32)).to(cuda, dtype) for h, d in ((H, D), (K, D), (K, Dv)))
    before = kflash.flash_attention.launches
    got = kflash.flash_attention(q, k, v, round_p=round_p)
    want = ref.attention_ref(q, k, v, round_p=round_p)
    torch.cuda.synchronize()
    assert kflash.flash_attention.launches == before + 1
    assert got.dtype == dtype and got.shape == (B, H, S, Dv)
    if dtype == torch.bfloat16 and not round_p:
        ulps, share = ref.bf16_ulp_gaps(got, want)
        assert ulps <= 1.0 and share <= 0.01, (ulps, share)
    else:
        tol = TOL_ATTN[dtype]
        torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                   atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["xlstm-125m", "phi-3-vision-4.2b",
                                  "musicgen-medium"])
def test_reduced_families_serve_on_the_card_as_on_the_cpu(cuda, arch):
    """The reduced xLSTM, vision and audio models (float32) with the same
    weights on the card and the CPU: identical greedy tokens, logits
    within 1e-4 of the CPU's; the attention kernel runs once a layer a
    prefill (never for the xLSTM)."""
    from repro_torch import convert
    from repro_torch.configs import get_config, reduce_config
    from repro_torch.models import LM
    cfg = reduce_config(get_config(arch))
    cpu_params = LM(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    card_params = convert.lm_params_from_numpy(
        cfg, convert.lm_params_to_numpy(cpu_params), device=cuda)
    rng = np.random.default_rng(0)
    if cfg.audio_codebooks:
        batch = {"codes": rng.integers(0, cfg.vocab_size, (2, 4, 20)),
                 "cond": rng.normal(size=(2, cfg.cond_len, cfg.cond_dim)
                                    ).astype(np.float32)}
    else:
        batch = {"tokens": rng.integers(0, cfg.vocab_size, (2, 20))}
        if cfg.vision:
            batch["patches"] = rng.normal(size=(
                2, cfg.num_patches, cfg.vision_dim)).astype(np.float32)
    out = {}
    with torch.inference_mode():
        for where, params in (("cpu", cpu_params), (cuda, card_params)):
            lm = LM(cfg, device=where)
            before = kflash.flash_attention.launches
            cache, logits = lm.prefill(params, batch, max_seq=32)
            launched = kflash.flash_attention.launches - before
            steps = [logits]
            for _ in range(6):
                tok = {"tokens": steps[-1].argmax(-1)}
                if cfg.audio_codebooks:
                    tok["cond"] = batch["cond"]
                steps.append(lm.decode(params, cache, tok)[0])
            out[str(where)] = [t.float().cpu() for t in steps]
    assert launched == (0 if cfg.family == "ssm" else cfg.num_layers)
    for got, want in zip(out[str(cuda)], out["cpu"]):
        assert torch.equal(got.argmax(-1), want.argmax(-1))
        assert ((got - want).abs().max() / want.abs().max()).item() <= 1e-4


# (B, H, K, S, Dqk, Dv): deepseek-v3's MLA at its training shape and on a
# ragged S, and the reduced MLA's 24 / 16 (q and k padded to 32); at (192,
# 128) also one position, and S = 64 and 65 (the bf16 kernels' 64-row tile
# edges) with two query heads a kv head (their fp32 partials and combine)
MLA_BWD_CASES = [(4, 128, 128, 1000, 192, 128), (1, 16, 16, 333, 192, 128),
                 (2, 4, 4, 40, 24, 16), (3, 4, 4, 77, 24, 16),
                 (2, 4, 4, 1, 192, 128), (1, 4, 2, 64, 192, 128),
                 (1, 4, 2, 65, 192, 128)]


def _mla_gaps(got, want):
    """``_rel_gaps``, but a gradient whose plain version is exactly zero
    (S = 1: one visible key, so p = 1 and dS = dP - Delta = 0, leaving dq
    and dk what the two sums' rounding makes them) is held against the
    largest of the call's plain gradients instead."""
    scale = max(w.float().abs().max().item() for w in want)
    return [(g.float() - w.float()).abs().max().item()
            / (w.float().abs().max().item() or scale)
            for g, w in zip(got, want)]


def _mla_inputs(case, dtype, cuda, seed=7):
    B, H, K, S, D, Dv = case
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(
        cuda, dtype) for shape in ((B, H, S, D), (B, K, S, D), (B, K, S, Dv),
                                   (B, H, S, Dv))]


@pytest.mark.cuda
@pytest.mark.parametrize("case", MLA_BWD_CASES, ids=str)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_flash_attention_on_the_card_trains_through_an_mla_gradient(
        cuda, case, dtype):
    """A gradient with Dv != D: one launch of the backward kernel, (dq, dk,
    dv) of q's, k's and v's shapes within ``RTOL_ATTN_BWD`` of autograd of
    ``attention_ref`` (``_mla_gaps``)."""
    q, k, v, do = _mla_inputs(case, dtype, cuda)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    before = kflash.flash_attention_bwd.launches
    o = kflash.flash_attention(*leaves, round_p=False)
    got = torch.autograd.grad(o, leaves, do)
    torch.cuda.synchronize()
    assert kflash.flash_attention_bwd.launches == before + 1
    assert [g.shape for g in got] == [t.shape for t in (q, k, v)]
    gaps = _mla_gaps(got, ref.attention_ref_grads(q, k, v, do))
    assert max(gaps) <= RTOL_ATTN_BWD[dtype], gaps


@pytest.mark.cuda
def test_flash_attention_bwd_at_mla_head_dims_is_bit_equal_twice(cuda):
    """The bf16 (192, 128) backward at deepseek-v3's training shape gives
    the same bits twice (no atomics)."""
    q, k, v, do = _mla_inputs(MLA_BWD_CASES[0], torch.bfloat16, cuda)
    o, lse = kflash._forward(q, k, v, True, None, 0, False, with_lse=True)
    first = kflash.flash_attention_bwd(q, k, v, o, do, lse)
    second = kflash.flash_attention_bwd(q, k, v, o, do, lse)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


# the dense family's bf16 backward at (128, 128), on two wgmma warpgroups a
# block (dkdv_kernel_wg2 / dq_kernel_wg2), (B, H, K, S, window, sink): with
# B K ceil(S / 64) >= 512 a dK/dV block sums its kv head's query heads
# (internlm2-1.8b's training shape, 16 / 8; qwen3-8b's, 32 / 8; 8 / 4 on a
# ragged S with a window and a sink no tile boundary meets), below it a
# block takes one head and writes fp32 partials that the dQ launch's
# combine blocks sum (qwen3-8b's heads on a ragged S, the window case of
# ATTN_BWD_CASES, a window with a sink, granite-34b's MQA 48 / 1, qwen3-32b's
# 64 / 8, one position and S = 64 and 65: the 64-row tiles' edges), and at
# one query head a kv head the blocks store dK and dV themselves
# (moonshot's 16 / 16; a window with a sink); then the same pair at (96,
# 96), its rows three 32-column slabs (a seventh entry, D = 96):
# phi-3-vision-4.2b's training shape (32 / 32, 4 x 1,128: the blocks store
# dK and dV), a ragged S (1, 4, 4, 333), GQA under SUM_HEADS_BLOCKS dK/dV
# blocks (8 / 2: per-head partials and the combine), a window with a sink
# (2, 4, 2, 300) and a block summing its kv head's heads (16 / 8)
DENSE_BWD_CASES = [(4, 16, 8, 1128, None, 0), (1, 32, 8, 333, None, 0),
                   (4, 16, 16, 1128, None, 0), (2, 2, 1, 130, 64, 0),
                   (1, 6, 2, 300, 100, 20), (2, 4, 4, 300, 100, 70),
                   (1, 48, 1, 256, None, 0), (1, 64, 8, 200, None, 0),
                   (2, 4, 2, 1, None, 0), (1, 4, 2, 64, None, 0),
                   (1, 4, 2, 65, None, 0), (4, 32, 8, 1128, None, 0),
                   (8, 8, 4, 1000, 300, 70),
                   (4, 32, 32, 1128, None, 0, 96), (1, 4, 4, 333, None, 0, 96),
                   (1, 8, 2, 1128, None, 0, 96), (2, 4, 2, 300, 100, 20, 96),
                   (4, 16, 8, 1128, None, 0, 96)]


def _dense_bwd_inputs(case, cuda, seed=9):
    B, H, K, S = case[:4]
    D = case[6] if len(case) > 6 else 128
    return _mla_inputs((B, H, K, S, D, D), torch.bfloat16, cuda, seed)


@pytest.mark.cuda
@pytest.mark.parametrize("D", [128, 96])
def test_dense_bwd_runs_on_wgmma_without_spills(cuda, D):
    """bf16 (D, D) at 128 and 96 names the two-warpgroup wgmma pair, the
    built library's ``-Xptxas -v`` report holds ``dkdv_kernel_wg2<D, D>``
    and ``dq_kernel_wg2<D, D>`` with no spill store, and no mma.sync kernel
    at (D, D), and its scratch holds fp32 partials only where a dK/dV
    block takes one query head of several."""
    import re
    from repro_torch.kernels import build
    assert kflash.backward_kernel(D, D, torch.bfloat16) == (
        "dkdv_kernel_wg2", "dq_kernel_wg2")
    log = build.build_library("flash_attention_bwd").with_suffix(
        ".log").read_text()
    spills, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            k = re.search(rf"((?:dkdv|dq)_kernel_\w+?)ILi{D}ELi{D}E", m[1])
            name = None if k is None or k[1].endswith("_f32") else k[1]
            continue
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and name:
            spills[name] = int(m[1])
    assert spills == {"dkdv_kernel_wg2": 0, "dq_kernel_wg2": 0}, spills
    # the scratch: Delta alone where a dK/dV block sums its kv head's heads
    # (internlm2's shape) or there is one a kv head (moonshot's, phi's),
    # Delta and every head's fp32 dK / dV partials where a block takes one
    # of several (granite-34b's MQA on one sequence; 8 / 2 on one)
    for (B, H, K, S), partials in (((4, 16, 8, 1128), False),
                                   ((4, 16, 16, 1128), False),
                                   ((4, 32, 32, 1128), False),
                                   ((1, 48, 1, 1128), True),
                                   ((1, 8, 2, 1128), True)):
        floats = build.scratch_floats("flash_attention_bwd", B, H, K, S, S,
                                      D, D, 1)
        want = -(-B * H * S // 4) * 4 + (B * H * S * 2 * D if partials
                                         else 0)
        assert floats == want, (B, H, K, S, floats, want)


@pytest.mark.cuda
@pytest.mark.parametrize("case", DENSE_BWD_CASES, ids=str)
def test_dense_bwd_on_wgmma_matches_plain_gradients(cuda, case):
    """One backward launch a gradient, on the wgmma pair, (dq, dk, dv) of
    q's, k's and v's shapes within ``RTOL_ATTN_BWD`` of autograd of
    ``attention_ref`` (``_mla_gaps``: at S = 1 dq and dk are zero)."""
    window, sink = case[4:6]
    q, k, v, do = _dense_bwd_inputs(case, cuda)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    before = (kflash.flash_attention_bwd.launches,
              kflash.flash_attention_bwd.wg_launches)
    o = kflash.flash_attention(*leaves, window=window, sink=sink,
                               round_p=False)
    got = torch.autograd.grad(o, leaves, do)
    torch.cuda.synchronize()
    assert (kflash.flash_attention_bwd.launches,
            kflash.flash_attention_bwd.wg_launches) == (before[0] + 1,
                                                        before[1] + 1)
    assert [g.shape for g in got] == [t.shape for t in (q, k, v)]
    assert all(torch.isfinite(g).all() for g in got)
    gaps = _mla_gaps(got, ref.attention_ref_grads(q, k, v, do, window=window,
                                                  sink=sink))
    assert max(gaps) <= RTOL_ATTN_BWD[torch.bfloat16], gaps


@pytest.mark.cuda
@pytest.mark.parametrize("case", [DENSE_BWD_CASES[i]
                                  for i in (0, 1, 4, 6, 12, 13, 15, 16, 17)],
                         ids=str)
def test_dense_bwd_on_wgmma_is_bit_equal_twice(cuda, case):
    """The (128, 128) backward gives the same bits twice at internlm2's
    training shape and with a window and a sink (a block summing its kv
    head's heads), and through the per-head partials' combine at 4, 3 and
    48 query heads a kv head (no atomics); the (96, 96) one at
    phi-3-vision's training shape (the blocks storing dK and dV), through
    the combine at 4 heads a kv head, with a window and a sink, and with a
    block summing 2 heads."""
    window, sink = case[4:6]
    q, k, v, do = _dense_bwd_inputs(case, cuda)
    o, lse = kflash._forward(q, k, v, True, window, sink, False,
                             with_lse=True)
    first = kflash.flash_attention_bwd(q, k, v, o, do, lse, True, window,
                                       sink)
    second = kflash.flash_attention_bwd(q, k, v, o, do, lse, True, window,
                                        sink)
    assert all(torch.equal(a, b) for a, b in zip(first, second))

# (B, S, di, n): the reference's shapes, S and di no block or chunk divides,
# n = 4, 8 (the reduced hymba) and 32, S below one saved-state interval, and
# hymba-1.5b's full width
SSM_BWD_SHAPES = [(1, 128, 256, 16), (2, 45, 200, 8), (2, 130, 64, 4),
                  (1, 70, 96, 32), (3, 1, 40, 16), (2, 193, 100, 16),
                  (4, 1128, 3200, 16)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SSM_BWD_SHAPES, ids=str)
@pytest.mark.parametrize("with_dh", [False, True], ids=["dy", "dy+dh"])
def test_ssm_scan_bwd_kernel_matches_plain_gradients(cuda, shape, with_dh):
    """The backward kernel through the autograd wrapper (one launch a
    backward) against autograd of ``ssm_scan_ref``, with and without a
    gradient of the final state."""
    B, S, di, n = shape
    rng = np.random.default_rng(6)

    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(cuda)

    xs = (t(rng.normal(size=(B, S, di))),
          t(rng.uniform(0.001, 0.1, size=(B, S, di))),
          t(-rng.uniform(0.5, 2.0, size=(di, n))),
          t(rng.normal(size=(B, S, n))), t(rng.normal(size=(B, S, n))),
          t(rng.normal(size=(di,))))
    dy = t(rng.normal(size=(B, S, di)))
    dh = t(rng.normal(size=(B, di, n))) if with_dh else None
    leaves = [a.clone().requires_grad_(True) for a in xs]
    before = (kssm.ssm_scan.launches, kssm.ssm_scan_bwd.launches)
    y, h = kssm.ssm_scan(*leaves)
    outs, grads = ((y, h), (dy, dh)) if with_dh else ((y,), (dy,))
    got = torch.autograd.grad(outs, leaves, grads)
    torch.cuda.synchronize()
    assert (kssm.ssm_scan.launches, kssm.ssm_scan_bwd.launches) == (
        before[0] + 1, before[1] + 1)
    want = ref.ssm_scan_ref_grads(*xs, dy, dh)
    gaps = _rel_gaps(got, want)
    assert max(gaps) <= RTOL_SSM_BWD, gaps


def _scan_case(shape, device, seed=6):
    """(inputs, dy, dh_final) of a scan backward at ``shape``."""
    B, S, di, n = shape
    rng = np.random.default_rng(seed)

    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(device)
    xs = (t(rng.normal(size=(B, S, di))),
          t(rng.uniform(0.001, 0.1, size=(B, S, di))),
          t(-rng.uniform(0.5, 2.0, size=(di, n))),
          t(rng.normal(size=(B, S, n))), t(rng.normal(size=(B, S, n))),
          t(rng.normal(size=(di,))))
    return xs, t(rng.normal(size=(B, S, di))), t(rng.normal(size=(B, di, n)))


# the scan backward's split at the saved states (64 steps): S one short of
# a chunk, one chunk, one past it, three chunks and a piece
SSM_BWD_SPLIT_SHAPES = [(2, 63, 96, 16), (2, 64, 96, 16), (2, 65, 96, 16),
                        (2, 193, 72, 8)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SSM_BWD_SPLIT_SHAPES, ids=str)
def test_ssm_scan_bwd_chunk_split_matches_plain_gradients(cuda, shape):
    """The chunk adjoints, their carries and the per-chunk gradients
    (``ssm_scan_bwd.cu``) against autograd of ``ssm_scan_ref`` where S meets
    the 64-step chunks in each way."""
    xs, dy, dh = _scan_case(shape, cuda)
    _, _, states = kssm._forward(*xs, with_states=True)
    got = kssm.ssm_scan_bwd(*xs, states, dy, dh)
    want = ref.ssm_scan_ref_grads(*xs, dy, dh)
    gaps = _rel_gaps(got, want)
    assert max(gaps) <= RTOL_SSM_BWD, gaps


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["ssm_scan", "flash_attention_bf16",
                                   "flash_attention_f32"])
def test_backward_kernels_are_deterministic(cuda, which):
    """Two backward launches on the same inputs give bit-equal gradients:
    no atomics, and no sum depends on the order blocks run in."""
    if which == "ssm_scan":
        xs, dy, dh = _scan_case((2, 193, 200, 16), cuda)
        _, _, states = kssm._forward(*xs, with_states=True)
        runs = [kssm.ssm_scan_bwd(*xs, states, dy, dh) for _ in range(2)]
    else:
        dtype = torch.bfloat16 if which.endswith("bf16") else torch.float32
        rng = np.random.default_rng(8)
        q, k, v, do = (torch.from_numpy(rng.normal(
            size=(2, h, 300, 64)).astype(np.float32)).to(cuda, dtype)
            for h in (6, 2, 2, 6))
        o, lse = kflash._forward(q, k, v, True, 100, 20, False, with_lse=True)
        runs = [kflash.flash_attention_bwd(q, k, v, o, do, lse, True, 100, 20)
                for _ in range(2)]
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(*runs))


@pytest.mark.cuda
def test_dispatch_counters_count_kernel_launches(cuda):
    """On the card each wrapper counts its kernel in
    ``kernels.dispatch.<op>.cuda``, one per launch, beside ``.launches``."""
    from repro_torch import obs
    params = torch.from_numpy(_perturbed(130)).to(cuda)
    ts = retention.time_grid(cuda)
    n0, p0 = (obs.value("kernels.dispatch.retention.cuda"),
              obs.value("kernels.dispatch.retention.plain"))
    before = kretention.retention_batch.launches
    for _ in range(3):
        kretention.retention_batch(params, ts)
    torch.cuda.synchronize()
    assert obs.value("kernels.dispatch.retention.cuda") == n0 + 3
    assert obs.value("kernels.dispatch.retention.plain") == p0
    assert kretention.retention_batch.launches == before + 3


@pytest.mark.cuda
def test_sanitizer_on_the_card(cuda):
    """A made NaN raises naming the op; an out-of-range gather raises
    before it launches, so the context survives and the card goes on; a
    sanitized characterization (kernel output check included) is clean and
    bit-equal to the plain one."""
    from repro_torch.analysis import sanitize
    with pytest.raises(FloatingPointError, match="aten.log"):
        sanitize.wrap(torch.log)(-torch.ones(4, device=cuda))
    with pytest.raises(IndexError, match="out-of-bounds"):
        sanitize.wrap(torch.gather)(torch.arange(8.0, device=cuda), 0,
                                    torch.tensor([3, 8], device=cuda))
    space = api.design_space(word_sizes=(16, 64), num_words=(16, 256))
    plain = api.DesignTable.from_configs(space, device=cuda)
    with sanitize.enabled_scope(True):
        checked = api.DesignTable.from_configs(space, device=cuda)
    torch.cuda.synchronize()
    for k in plain.metric_names:
        np.testing.assert_array_equal(plain[k], checked[k], err_msg=k)
    bad = torch.tensor([1.0, float("nan")], device=cuda)

    def launch():
        sanitize.check_kernel("retention", (torch.ones(2, device=cuda),),
                              (bad,))
    with pytest.raises(FloatingPointError, match="kernel retention"):
        sanitize.wrap(launch)()


@pytest.mark.cuda
@pytest.mark.parametrize("k", [2, 4])
def test_sharded_scoring_on_the_card_is_bit_equal(cuda, k):
    """``score_grid`` / ``score_grid_corners`` over ``[cuda:0] * k``: the
    blocks' results equal the plain call's bit for bit."""
    from repro_torch.hetero import system
    table = api.DesignTable.build(corners=tuple(corners.CORNERS),
                                  device=cuda)
    rng = np.random.default_rng(k)
    idx = rng.integers(0, len(table), (9999, 4)).astype(np.int32)
    idx[rng.random(idx.shape) < 0.01] = -1
    cap_bits, f_req = [2e5, 1e6, 3.2e7, 6.4e7], [1.2e9, 5e8, 1e9, 2e9]
    per_corner = [table.corner_metrics(c) for c in table.corner_labels]
    for score, first in ((system.score_grid, table.metrics),
                         (system.score_grid_corners, per_corner)):
        plain = score(first, idx, cap_bits, f_req, device=cuda)
        sharded = score(first, idx, cap_bits, f_req, sharded=True,
                        devices=[cuda] * k, device=cuda)
        for m in system.SYSTEM_METRICS:
            np.testing.assert_array_equal(sharded[m], plain[m], err_msg=m)


@pytest.mark.cuda
def test_sharded_scoring_across_cards_is_bit_equal(cuda):
    """``devices=None`` on a host with several cards: the blocks run on
    every visible card, are gathered onto the first, and the scores and
    ``compose(sharded=True)`` equal the plain call's bit for bit."""
    n_dev = torch.cuda.device_count()
    if n_dev < 2:
        pytest.skip("needs more than one card")
    from repro_torch import obs
    from repro_torch.hetero import system
    from repro_torch.parallel import grid
    ran_on = grid.shard_leading(
        lambda x: torch.full((x.shape[0],), x.device.index,
                             device=x.device),
        torch.zeros(4 * n_dev + 1, device=cuda))
    assert ran_on.device == torch.device("cuda", 0)
    assert sorted(set(ran_on.tolist())) == list(range(n_dev))
    table = api.DesignTable.build(corners=tuple(corners.CORNERS),
                                  device=cuda)
    rng = np.random.default_rng(n_dev)
    idx = rng.integers(0, len(table), (9999, 4)).astype(np.int32)
    idx[rng.random(idx.shape) < 0.01] = -1
    cap_bits, f_req = [2e5, 1e6, 3.2e7, 6.4e7], [1.2e9, 5e8, 1e9, 2e9]
    per_corner = [table.corner_metrics(c) for c in table.corner_labels]
    for score, first in ((system.score_grid, table.metrics),
                         (system.score_grid_corners, per_corner)):
        plain = score(first, idx, cap_bits, f_req, device=cuda)
        n0 = obs.value("parallel.shard_calls")
        sharded = score(first, idx, cap_bits, f_req, sharded=True,
                        device=cuda)
        assert obs.value("parallel.shard_calls") == n0 + 1
        for m in system.SYSTEM_METRICS:
            np.testing.assert_array_equal(sharded[m], plain[m], err_msg=m)
    nominal = api.DesignTable.build(device=cuda)
    power_bb = ComposePolicy(objective="power", candidate_mode="all_feasible",
                             search="branch_and_bound")
    for policy in (ComposePolicy(), power_bb):
        task = gainsight.nlevel_task(3)
        plain = compose(nominal, task, compose_policy=policy, device=cuda)
        sharded = compose(nominal, task, compose_policy=policy, sharded=True,
                          device=cuda)
        assert sharded.labels() == plain.labels()
        for a, b in zip(plain.ranked, sharded.ranked):
            assert a.metrics == b.metrics


@pytest.mark.cuda
def test_explore_over_arch_tasks_on_the_card_matches_the_cpu(cuda, tmp_path):
    """Requirements from models: two architectures' train_4k and decode_32k
    records become ``arch_task``s, and ``explore`` over them with
    ``benchmarks/arch_dse.py``'s space and policy dispatches the retention
    kernel on the card and picks what the CPU picks."""
    from repro_torch import obs
    from repro_torch.core.select import SelectionPolicy
    from repro_torch.launch import dryrun
    from repro_torch.profiler import traffic
    for arch in ("qwen3-8b", "hymba-1.5b"):
        for shape in ("train_4k", "decode_32k"):
            assert dryrun.main(["--arch", arch, "--shape", shape,
                                "--out", str(tmp_path)]) == 0
    tasks = traffic.available_arch_tasks(outdir=str(tmp_path))
    assert len(tasks) == 4
    space = api.design_space(mem_types=("sram6t", "gc_sisi", "gc_ossi",
                                        "gc_osos", "gc_osos_hvt"))
    policy = SelectionPolicy(preference=("os-os", "os-si", "si-si", "sram"),
                             allow_refresh=True)
    n0, p0 = (obs.value("kernels.dispatch.retention.cuda"),
              obs.value("kernels.dispatch.retention.plain"))
    card = api.explore(space=space, tasks=tasks, policy=policy, device=cuda)
    torch.cuda.synchronize()
    assert obs.value("kernels.dispatch.retention.cuda") > n0
    assert obs.value("kernels.dispatch.retention.plain") == p0
    cpu = api.explore(space=space, tasks=tasks, policy=policy, device="cpu")
    assert card.labels() == cpu.labels()


# ---------------------------------------------------------------------------
# the sharded paths across the visible cards (NCCL): one worker a card
# ---------------------------------------------------------------------------

# tests/test_torch_train.py's gates: the step's loss and grad_norm, and
# every parameter and AdamW moment, by depth
RTOL_TRAIN_GRAD = {2: 3e-4, 4: 2e-3}
RTOL_TRAIN_STEP = {"loss": 1e-5, "grad_norm": RTOL_TRAIN_GRAD[4]}
RTOL_TRAIN_UPDATE, RTOL_TRAIN_FLIPS = 0.1, 1e-3    # tests/test_torch_sharding
SHARDED_TIMEOUT = 300


def _cards(cuda):
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip("needs at least 2 cards")
    return n, ((n // 2, 2) if n % 2 == 0 else (n, 1))


@pytest.mark.cuda
def test_sharded_train_step_on_every_card_matches_one_card(cuda, tmp_path):
    """The reduced hymba (float32, 4 layers) on a ("data", "model") mesh
    over every card against the same two steps on one card (lr 0, then lr
    5e-4): loss and grad_norm within RTOL_TRAIN_STEP, moments within
    RTOL_TRAIN_GRAD[4], parameters within RTOL_TRAIN_UPDATE lr where the
    moment is above its noise and apart by more than lr / 10 in at most
    RTOL_TRAIN_FLIPS of the entries (``torch_sharded_checks``); the
    attention and scan kernels (forward and backward) launch on each
    rank's shards."""
    import torch_sharded_checks as checks
    from repro_torch.launch import spmd
    n, mesh = _cards(cuda)
    out = spmd.launch(checks.train_check, n, (dict(
        arch="hymba-1.5b", reduced=True, mesh=mesh, batch=4, seq=24,
        data_seed=3, steps=[0, 1], base_lr=1e-3, warmup=2, single=True),),
        timeout=SHARDED_TIMEOUT, store_dir=str(tmp_path))[0]
    assert out["mesh"] == mesh
    for k, tol in RTOL_TRAIN_STEP.items():
        assert out["gaps"][k] <= tol, (k, out["gaps"])
    for k in ("m", "v"):
        assert out["gaps"][k] <= RTOL_TRAIN_GRAD[4], (k, out["gaps"])
    assert out["gaps"]["update"] <= RTOL_TRAIN_UPDATE, out["gaps"]
    assert out["gaps"]["flips"] <= RTOL_TRAIN_FLIPS, out["gaps"]
    assert out["rows"][1]["lr"] > 0
    launches = out["rows"][0]["launches"]
    assert all(v > 0 for v in launches.values()), launches


@pytest.mark.cuda
def test_sharded_expert_parallel_moe_matches_the_unsharded_block(cuda,
                                                                 tmp_path):
    """The reduced moonshot's MoE block with REPRO_MOE_SHARDMAP=1 on a
    mesh over every card (its experts over "model") against the unsharded
    block on one card: y within 1e-5, load within 1e-7, gradients within
    RTOL_TRAIN_GRAD[2]."""
    from repro_torch.configs import get_config, reduce_config
    import torch_sharded_checks as checks
    from repro_torch.launch import spmd
    from repro_torch.models import moe
    n, mesh = _cards(cuda)
    cfg = reduce_config(get_config("moonshot-v1-16b-a3b"))
    gen = torch.Generator().manual_seed(0)
    p = moe.init_moe(gen, cfg, torch.float32, "cpu")
    x = torch.randn((2 * mesh[0], 16, cfg.d_model), generator=gen)
    from repro_torch.parallel.sharding import map_tree
    out = spmd.launch(checks.moe_check, n, (dict(
        arch="moonshot-v1-16b-a3b", reduced=True, mesh=mesh,
        p=map_tree(lambda t: t.numpy(), p), x=x.numpy(), plain=True),),
        timeout=SHARDED_TIMEOUT, env={"REPRO_MOE_SHARDMAP": "1"},
        store_dir=str(tmp_path))[0]
    plain = out["plain"]
    assert np.max(np.abs(out["y"] - plain["y"])) <= 1e-5
    assert np.max(np.abs(out["load"] - plain["load"])) <= 1e-7
    for k, want in plain["grads"].items():
        if not np.any(want):
            assert not np.any(out["grads"][k]), k
            continue
        gap = np.max(np.abs(out["grads"][k] - want)) / np.max(np.abs(want))
        assert gap <= RTOL_TRAIN_GRAD[2], (k, gap)


@pytest.mark.cuda
def test_sharded_ef_int8_all_reduce_over_nccl(cuda, tmp_path):
    """``ef_int8_psum_mean`` over every card, two steps: one shared scale,
    the mean the int32 sum of the payloads times it over n, and the
    residual what the payload left out."""
    import torch_sharded_checks as checks
    from repro_torch.launch import spmd
    n, _ = _cards(cuda)
    g = [[{"w": np.random.default_rng(100 * r + s).normal(
        size=(64, 48)).astype(np.float32)} for s in range(2)]
        for r in range(n)]
    per_rank = spmd.launch(checks.ef_int8_check, n, ({"g": g},),
                           timeout=SHARDED_TIMEOUT, store_dir=str(tmp_path))
    resid = [np.zeros((64, 48), np.float32) for _ in range(n)]
    for s in range(2):
        x = [g[r][s]["w"] + resid[r] for r in range(n)]
        scale = np.float32(max(np.abs(a).max() for a in x)) / np.float32(127)
        total = sum(per_rank[r][s]["q"]["w"].astype(np.int32)
                    for r in range(n))
        for r in range(n):
            got = per_rank[r][s]
            assert got["scale"]["w"] == pytest.approx(float(scale), rel=1e-7)
            np.testing.assert_array_equal(
                got["q"]["w"], np.clip(np.round(x[r] / got["scale"]["w"]),
                                       -127, 127).astype(np.int8))
            np.testing.assert_allclose(
                got["mean"]["w"], total * got["scale"]["w"] / n, rtol=1e-6)
            np.testing.assert_allclose(
                got["resid"]["w"], x[r] - got["q"]["w"] * got["scale"]["w"],
                rtol=1e-6, atol=1e-7)
            resid[r] = got["resid"]["w"]


@pytest.mark.cuda
def test_sharded_checkpoint_round_trip_across_meshes(cuda, tmp_path):
    """A checkpoint of the sharded state restores bit-equal on its mesh, on
    a data-only mesh over every card and on one card, and one written on
    one card restores onto the mesh."""
    import torch_sharded_checks as checks
    from repro_torch.launch import spmd
    n, mesh = _cards(cuda)
    res = spmd.launch(checks.reshard_check, n, (dict(
        arch="hymba-1.5b", reduced=True, mesh=mesh, dir=str(tmp_path)),),
        timeout=SHARDED_TIMEOUT, store_dir=str(tmp_path))[0]
    for k in ("same_mesh", "data_mesh", "one_device", "to_mesh"):
        assert res[k] is True, k
    assert res["data_mesh_placed"] == (n,)


# the launch verifier and the host-sync witness (repro_torch.analysis)
ANALYSIS_ROOT = __import__("pathlib").Path(__file__).resolve().parents[1]


@pytest.mark.cuda
@pytest.mark.parametrize("lib", ["retention", "ssm_scan", "ssm_scan_bwd",
                                 "flash_attention", "flash_attention_bwd"])
def test_guarded_launches_write_exactly_their_outputs(cuda, lib):
    """LG02-LG04: every card profile of ``lib`` launched twice directly in
    guarded buffers: no sentinel left, no guard band or input touched, no
    NaN where the plain version is finite, bit-equal twice."""
    from repro_torch.analysis.semantic import lg
    profiles = [p for p in lg.card_profiles() if p.lib == lib]
    assert profiles
    issues = {p.label + " " + p.route: lg.run_card_profile(p, cuda, i)
              for i, p in enumerate(profiles)}
    assert not any(issues.values()), {k: v for k, v in issues.items() if v}


@pytest.mark.cuda
def test_host_sync_witness_on_the_decode_step(cuda):
    """Every sync of the reduced hymba's warm decode step lies on a line
    the static HS tier flags."""
    from repro_torch.analysis.astutil import Project
    from repro_torch.analysis.semantic import witness
    sites = witness.witness_path(ANALYSIS_ROOT, witness.PATHS["decode"],
                                 cuda)
    assert sites
    assert witness.unflagged(Project(ANALYSIS_ROOT), sites) == []


@pytest.mark.cuda
def test_every_route_the_entry_points_launch_is_profiled(cuda):
    """LG05 on the card and RC02: the entry points' launches take profiled
    routes, and a repeat drive builds and loads nothing."""
    from repro_torch.analysis.semantic import capture, lg, rc
    with capture.capture_launches(ANALYSIS_ROOT) as caps:
        first, repeat, errors = rc.audit_builds(cuda)
    assert errors == [] and repeat == (0, 0)
    assert {c.library for c in caps} == set(lg.WRAPPERS)
    assert lg.check_routes_seen([(c.library, c.route, c.path, c.line)
                                 for c in caps]) == []


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,B,S,D", [
    (torch.float32, 65536, 64, 16),          # dim3(n_kt, B*K), dim3(n_qt, B*H)
    (torch.bfloat16, 1, 64 * 32768, 64),     # q tiles + combine rows on y
], ids=["f32-batch-heads", "bf16-q-tiles"])
def test_backward_launch_refuses_a_grid_past_65535_on_y(cuda, dtype, B, S,
                                                       D):
    """The attention backward's launch function refuses a shape whose grid
    y would pass 65,535 (``lg.launch_refuses`` models it; LG01 checks the
    shapes it takes)."""
    from repro_torch.kernels import flash_attention as kflash
    q, k, v = (torch.randn(B, 1, S, D, device=cuda, dtype=dtype)
               for _ in range(3))
    o = torch.zeros_like(q)
    lse = torch.zeros(B, 1, S, device=cuda)
    with pytest.raises(RuntimeError, match="invalid configuration"):
        kflash.flash_attention_bwd(q, k, v, o, o, lse)
