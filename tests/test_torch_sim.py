"""``repro_torch.sim`` (the trace-replay re-rank) on the CPU against the JAX
reference: traces value for value, the closed-form cases of the replay
(collision, stall, expiry, refresh gating, adaptive turnover, Arrhenius
drift, sentinels, validation), ``simulate_traces`` on the same columns,
the batched replay against its per-composition oracle, and
``compose(refine="simulate")`` / ``api.simulate`` / ``Compiler.simulate``
with the re-rank orders, the cache and the cold-boost case.

Traces are float64 numpy and must be bit-equal. Replayed metrics (float32
on both sides): rtol ``RTOL_SIM``. Re-rank orders and composition sets are
discrete and compared exactly; each such test prints the smallest relative
gap between adjacent re-rank keys, so a flip at a near tie can be told
from a fault. ``python tests/test_torch_sim.py`` prints the measured gaps.
"""
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.core import bitcells as jbitcells
from repro.core import corners as jcorners
from repro.core import gainsight as jgainsight
from repro.core import retention as jretention
from repro.core.select import Bucket as JBucket
from repro.core.select import LevelReq as JLevelReq
from repro.core.select import TaskReq as JTaskReq
from repro.hetero import ComposePolicy as JComposePolicy
from repro.hetero import compose as jcompose
from repro.hetero import expand as jexpand
from repro.sim import SimPolicy as JSimPolicy
from repro.sim import simulate_traces as jsimulate_traces
from repro.sim import task_traces as jtask_traces
from repro.sim.rerank import composition_idx as jcomposition_idx
from repro.sim.trace import phase_trace as jphase_trace
from repro_torch import api, convert
from repro_torch.api import Compiler, SimPolicy, simulate
from repro_torch.core import corners, gainsight
from repro_torch.core.select import Bucket, LevelReq, TaskReq
from repro_torch.hetero import ComposePolicy, compose, composition_eval_count
from repro_torch.hetero import expand
from repro_torch.sim import (DEFAULT_REFRESH_MARGIN, refresh_intervals,
                             sim_eval_count, simulate_traces, task_traces)
from repro_torch.sim import engine
from repro_torch.sim.engine import SIM_METRICS
from repro_torch.sim.refresh import refresh_interval_s
from repro_torch.sim.rerank import composition_idx, sim_cols
from repro_torch.sim.trace import phase_trace

# replayed float32 metrics, port vs JAX on the same columns and policies.
# Measured: <= 8.1e-7 (XLA contracts some products into FMAs and the port,
# adding one op a launch, does not; every time and stall column is equal)
RTOL_SIM = 1e-5
# the port's table against the JAX solver's retention (the tables' parity)
RTOL_TABLE = 2e-6
CPU = "cpu"
# the policies the replay is held to JAX under: the default, the adaptive
# controller with a heating die, expiry rewrites instead of refresh, and a
# short three-phase window
POLICIES = {
    "default": {},
    "adaptive-drift": dict(adaptive_refresh=True, temp_drift_k=30.0),
    "expiry": dict(refresh=False, rewrite_overhead=3.0),
    "short": dict(phases=("prefill", "decode", "train_step"), n_bins=7,
                  duration_s=2e-4, refresh_margin=0.5),
}


def _task(B, L, T):
    """The reference test's 4-slot, 2-level replay task."""
    return T("x", "x", {
        "L1": L("L1", 1 << 20, (B(0.6, 1.2e9, 2e-6), B(0.4, 5e8, 1e-4))),
        "L2": L("L2", 64 << 20, (B(0.5, 1e9, 1e-3), B(0.5, 2e9, 3e-6)))})


def _one_slot(B, L, T, cap_bits=1024, f_hz=1e8, lifetime_s=1e-3):
    return T("toy", "toy", {
        "L1": L("L1", cap_bits, (B(1.0, f_hz, lifetime_s),))})


PORT = (Bucket, LevelReq, TaskReq)
JAX = (JBucket, JLevelReq, JTaskReq)


def _toy_cols(retention_s=1e-4, bits=1024.0, word_bits=32.0, e_read=1e-12,
              e_write=2e-12, f_op=1e9, p_leak=1e-6):
    return {k: np.array([v], np.float64) for k, v in [
        ("bits", bits), ("word_bits", word_bits), ("e_read_j", e_read),
        ("e_write_j", e_write), ("f_op_hz", f_op), ("p_leak_w", p_leak),
        ("retention_s", retention_s)]}


def _max_rel(got, want) -> float:
    """Largest |got - want| / |want| over the finite entries (inf and 0
    must sit in the same places)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    fin = np.isfinite(want) & (want != 0)
    np.testing.assert_array_equal(got[~fin & np.isfinite(want)],
                                  want[~fin & np.isfinite(want)])
    if not fin.any():
        return 0.0
    return float(np.max(np.abs(got[fin] - want[fin]) / np.abs(want[fin])))


def _sim_gaps(got, want) -> dict:
    """Per-metric max rel gap, combined and per phase."""
    gaps = {m: _max_rel(got[m], want[m]) for m in SIM_METRICS}
    for ph in want["phases"]:
        for m in SIM_METRICS:
            gaps[f"{ph}/{m}"] = _max_rel(got["phases"][ph][m],
                                         want["phases"][ph][m])
    return gaps


def _key_gap(report) -> float:
    """Smallest relative gap between adjacent simulated energies of the
    re-ranked list (the primary sim key under objective "energy")."""
    e = np.array([c.metrics["sim_e_total_j"] for c in report.ranked])
    e = e[np.isfinite(e)]
    if len(e) < 2:
        return float("inf")
    d = np.abs(np.diff(e)) / np.maximum(np.abs(e[:-1]), 1e-300)
    return float(d.min())


@pytest.fixture(scope="module")
def jtable():
    return japi.DesignTable.from_configs(japi.design_space())


@pytest.fixture(scope="module")
def own_table():
    return api.DesignTable.build(device=CPU)


@pytest.fixture(scope="module")
def carried(jtable):
    """The JAX table's columns carried into a port DesignTable."""
    return convert.table_from_numpy(
        {k: jtable[k] for k in jtable.AXIS_NAMES}, jtable.metrics)


@pytest.fixture(scope="module", params=["carried", "own"])
def table(request, carried, own_table):
    return carried if request.param == "carried" else own_table


def _grid(n, seed=0):
    """The reference test's (41, 4) composition grid with a sentinel."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, n, size=(41, 4)).astype(np.int32)
    idx[5, 2] = -1
    return idx


# ------------------------------------------------------------------- refresh
def test_refresh_interval_parity_with_retention_solver(own_table):
    """Intervals are margin x the table's own retention, and that retention
    is the JAX solver's within the tables' parity."""
    iv = refresh_intervals(own_table.metrics)
    np.testing.assert_allclose(
        iv, DEFAULT_REFRESH_MARGIN
        * np.asarray(own_table["retention_s"], np.float64), rtol=0, atol=0)
    rows = np.where((own_table["mem_type"] == "gc_sisi")
                    & ~own_table["level_shift"])[0]
    t_solver = float(jretention.retention_time(
        jbitcells.BITCELLS["gc_sisi"], 0))
    np.testing.assert_allclose(iv[rows], DEFAULT_REFRESH_MARGIN * t_solver,
                               rtol=RTOL_TABLE)


def test_sim_policy_and_refresh_margin_validation():
    """(0, 1] margins at every entry point and the drift bound, as the
    reference rejects them; the policy's fields and defaults are the
    reference's (the sim cache key hashes them)."""
    import dataclasses
    assert dataclasses.asdict(SimPolicy()) == dataclasses.asdict(JSimPolicy())
    for bad in (0.0, -1.0, 1.5, float("inf"), float("nan")):
        with pytest.raises(ValueError, match="margin"):
            refresh_interval_s(np.array([1e-3]), bad)
        with pytest.raises(ValueError, match="margin"):
            refresh_intervals({"retention_s": np.array([1e-3])}, margin=bad)
        with pytest.raises(ValueError, match="margin"):
            SimPolicy(refresh_margin=bad)
    for bad in (float("nan"), float("inf"), -300.0, -350.0):
        with pytest.raises(ValueError, match="temp_drift_k"):
            SimPolicy(temp_drift_k=bad)
    with pytest.raises(ValueError):
        SimPolicy(objective="nosuch")
    with pytest.raises(ValueError):
        SimPolicy(phases=("warmup",))
    with pytest.raises(ValueError, match="at least one"):
        simulate_traces(_toy_cols(), np.zeros((1, 1), np.int32), [],
                        device=CPU)
    with pytest.raises(KeyError, match="word_bits"):
        cols = _toy_cols()
        del cols["word_bits"]
        simulate_traces(cols, np.zeros((1, 1), np.int32),
                        [phase_trace(_one_slot(*PORT), "decode")],
                        device=CPU)
    assert SimPolicy() == SimPolicy(adaptive_refresh=False, temp_drift_k=0.0)


# -------------------------------------------------------------------- traces
@pytest.mark.parametrize("phase", ["prefill", "decode", "train_step"])
@pytest.mark.parametrize("window", [(1e-3, 32), (2e-3, 48), (1e-6, 1)],
                         ids=str)
def test_traces_equal_jax_value_for_value(phase, window):
    """Every field of every phase trace and its fingerprint, bit for bit,
    for the 4-slot task and a Table-2 task; reads integrate to f·duration."""
    duration_s, n_bins = window
    for got_task, want_task in ((_task(*PORT), _task(*JAX)),
                                (gainsight.TASKS[2], jgainsight.TASKS[2])):
        got = phase_trace(got_task, phase, duration_s=duration_s,
                          n_bins=n_bins)
        want = jphase_trace(want_task, phase, duration_s=duration_s,
                            n_bins=n_bins)
        for f in ("t_bin_s", "reads", "write_bits", "occupancy", "cap_bits",
                  "f_req_hz", "lifetime_s"):
            np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                          err_msg=f)
        assert got.fingerprint() == want.fingerprint()
        np.testing.assert_allclose(got.reads.sum(axis=1),
                                   got.f_req_hz * got.duration_s, rtol=1e-9)


def test_trace_phase_envelopes():
    task = TaskReq("t", "t", {"L2": LevelReq("L2", 1 << 20, (
        Bucket(0.5, 1e9, 1e-6),        # short-lived (activations)
        Bucket(0.5, 1e9, 10.0)))})     # long-lived  (KV / weights)
    pre = phase_trace(task, "prefill", duration_s=1e-3, n_bins=16)
    dec = phase_trace(task, "decode", duration_s=1e-3, n_bins=16)
    trn = phase_trace(task, "train_step", duration_s=1e-3, n_bins=16)
    assert np.all(np.diff(pre.occupancy[1]) > 0)
    assert pre.occupancy[1][0] < 0.1 and pre.occupancy[1][-1] > 0.9
    np.testing.assert_allclose(pre.occupancy[0], 1.0)
    np.testing.assert_allclose(dec.occupancy, 1.0)
    np.testing.assert_allclose(
        dec.reads, np.broadcast_to(dec.reads[:, :1], dec.reads.shape))
    peak = int(np.argmax(trn.occupancy[0]))
    assert 0 < peak < trn.n_bins - 1
    assert np.all(np.diff(trn.occupancy[0][:peak]) > 0)
    assert np.all(np.diff(trn.occupancy[0][peak + 1:]) < 0)
    assert trn.reads[0][-1] > trn.reads[0][0]
    with pytest.raises(ValueError):
        phase_trace(task, "nosuch")
    with pytest.raises(ValueError, match="n_bins"):
        phase_trace(task, "decode", n_bins=0)


def test_trace_write_turnover_arithmetic():
    """Decode, flat occupancy: writes are exactly occ·cap·t_bin/lifetime,
    no phantom first-bin fill."""
    tr = phase_trace(_one_slot(*PORT, cap_bits=4096, lifetime_s=5e-4),
                     "decode", duration_s=1e-3, n_bins=8)
    np.testing.assert_allclose(tr.write_bits, 4096 * (1e-3 / 8) / 5e-4,
                               rtol=1e-12)


# -------------------------------------------------------- engine arithmetic
def _both(cols, idx, task_kw, phase, window, policy_kw):
    """The port's and JAX's replay of one one-slot trace."""
    got = simulate_traces(
        cols, idx, [phase_trace(_one_slot(*PORT, **task_kw), phase,
                                *window)],
        policy=SimPolicy(**policy_kw), device=CPU)
    want = jsimulate_traces(
        cols, idx, [jphase_trace(_one_slot(*JAX, **task_kw), phase,
                                 *window)],
        policy=JSimPolicy(**policy_kw))
    for m, gap in _sim_gaps(got, want).items():
        assert gap <= RTOL_SIM, (m, gap)
    return got


def test_collision_and_stall_arithmetic():
    """One slot, one bin, refresh scheduled: ops, utilization, stall,
    collisions and every energy term by hand."""
    d, life, ret = 1e-3, 1e-2, 1e-4
    out = _both(_toy_cols(retention_s=ret), np.array([[0]], np.int32),
                dict(cap_bits=1024, f_hz=2e12, lifetime_s=life), "decode",
                (d, 1), dict(refresh=True))
    reads = 2e12 * d
    wops = (1024 * d / life) / 32.0
    refr = (1024 / 32.0) * d / (DEFAULT_REFRESH_MARGIN * ret)
    cap_ops = 1e9 * d
    util = (reads + wops + refr) / cap_ops
    assert util > 1.0
    t_sim = d * util
    assert out["util_peak"][0] == pytest.approx(util, rel=1e-5)
    assert out["t_sim_s"][0] == pytest.approx(t_sim, rel=1e-5)
    assert out["stall_frac"][0] == pytest.approx(util - 1.0, rel=1e-4)
    assert out["collisions"][0] == pytest.approx(
        refr * min((reads + wops) / cap_ops, 1.0), rel=1e-5)
    assert out["e_dyn_j"][0] == pytest.approx(reads * 1e-12 + wops * 2e-12,
                                              rel=1e-5)
    assert out["e_refresh_j"][0] == pytest.approx(refr * 3e-12, rel=1e-5)
    assert out["e_rewrite_j"][0] == 0.0
    assert out["e_leak_j"][0] == pytest.approx(1e-6 * t_sim, rel=1e-5)
    assert out["e_total_j"][0] == pytest.approx(
        out["e_dyn_j"][0] + out["e_refresh_j"][0] + out["e_leak_j"][0],
        rel=1e-6)


def test_expiry_rewrite_arithmetic():
    d, life, ret, ovh = 1e-3, 1e-2, 1e-4, 2.0
    out = _both(_toy_cols(retention_s=ret), np.array([[0]], np.int32),
                dict(cap_bits=1024, f_hz=1e6, lifetime_s=life), "decode",
                (d, 4), dict(refresh=False, rewrite_overhead=ovh))
    rewr_ops = 1.0 * 1024 * d / ret / 32.0
    assert out["e_rewrite_j"][0] == pytest.approx(rewr_ops * 2e-12 * ovh,
                                                  rel=1e-5)
    assert out["e_refresh_j"][0] == 0.0


@pytest.mark.parametrize("refresh", [True, False])
def test_refresh_gates_on_retention_vs_lifetime(refresh):
    out = _both(_toy_cols(retention_s=1e-3), np.array([[0]], np.int32),
                dict(lifetime_s=1e-5), "decode", (1e-3, 2),
                dict(refresh=refresh))
    assert out["e_refresh_j"][0] == 0.0
    assert out["e_rewrite_j"][0] == 0.0
    assert out["collisions"][0] == 0.0


def test_adaptive_refresh_scales_by_write_turnover():
    d, life, ret, cap = 1e-3, 5e-4, 1e-4, 4096
    cols = _toy_cols(retention_s=ret, bits=4096.0)
    idx = np.array([[0]], np.int32)
    task_kw = dict(cap_bits=cap, f_hz=1e6, lifetime_s=life)
    base = _both(cols, idx, task_kw, "decode", (d, 8), dict(refresh=True))
    adap = _both(cols, idx, task_kw, "decode", (d, 8),
                 dict(refresh=True, adaptive_refresh=True))
    tr = phase_trace(_one_slot(*PORT, **task_kw), "decode", d, 8)
    turn = float(tr.write_bits[0, 0]) / cap
    assert 0.0 < turn < 1.0
    assert adap["e_refresh_j"][0] == pytest.approx(
        (1.0 - turn) * base["e_refresh_j"][0], rel=1e-5)
    assert adap["e_refresh_j"][0] < base["e_refresh_j"][0]
    assert adap["e_dyn_j"][0] == base["e_dyn_j"][0]
    refr = (4096 / 32.0) * d / (DEFAULT_REFRESH_MARGIN * ret)
    assert base["e_refresh_j"][0] == pytest.approx(refr * 3e-12, rel=1e-5)


def test_temp_drift_follows_arrhenius_closed_form():
    d, life, ret, drift, n = 1e-3, 1e-2, 1e-4, 60.0, 8
    cols = _toy_cols(retention_s=ret)
    idx = np.array([[0]], np.int32)
    task_kw = dict(cap_bits=1024, f_hz=1e6, lifetime_s=life)
    cold = _both(cols, idx, task_kw, "decode", (d, n), dict(refresh=True))
    hot = _both(cols, idx, task_kw, "decode", (d, n),
                dict(refresh=True, temp_drift_k=drift))
    t_bin = d / n
    t_now = engine._T_NOMINAL_K + drift * (np.arange(n) * t_bin) / d
    rs = np.exp(engine._EA_OVER_KB_K
                * (1.0 / t_now - 1.0 / engine._T_NOMINAL_K))
    e_ref = np.sum((1024 / 32.0) * t_bin
                   / (DEFAULT_REFRESH_MARGIN * ret * rs)) * 3e-12
    assert hot["e_refresh_j"][0] == pytest.approx(e_ref, rel=1e-4)
    assert hot["e_refresh_j"][0] > cold["e_refresh_j"][0]
    cold_rw = _both(cols, idx, task_kw, "decode", (d, n),
                    dict(refresh=False))
    hot_rw = _both(cols, idx, task_kw, "decode", (d, n),
                   dict(refresh=False, temp_drift_k=drift))
    assert hot_rw["e_rewrite_j"][0] > cold_rw["e_rewrite_j"][0]


def test_drift_and_adaptive_switches_off_are_exact():
    """With no drift the Arrhenius factor is exactly 1.0 (1/300 K as a
    float32 reciprocal equals the reference's constant) and with the
    controller off its factor is exactly 1.0: the replay then equals a
    float32 numpy replay written without either factor, bit for bit."""
    t300 = torch.tensor(300.0)
    assert torch.reciprocal(t300).item() == float(engine._INV_T_NOMINAL)
    assert np.float32(1.0) / np.float32(300.0) == engine._INV_T_NOMINAL
    f32 = np.float32
    cols = _toy_cols(retention_s=1e-4, bits=4096.0)
    tr = phase_trace(_one_slot(*PORT, cap_bits=4096, f_hz=1e6,
                               lifetime_s=5e-4), "decode", 1e-3, 8)
    out = simulate_traces(cols, np.array([[0]], np.int32), [tr],
                          policy=SimPolicy(refresh=True), device=CPU)
    words = f32(4096.0) / f32(32.0)
    interval = f32(DEFAULT_REFRESH_MARGIN) * f32(1e-4)
    e_rw = f32(1e-12) + f32(2e-12)
    e_ref = f32(0.0)
    for t in range(tr.n_bins):
        occ, t_bin = f32(tr.occupancy[0, t]), f32(tr.t_bin_s[t])
        refr = f32(f32(1.0) * f32(1.0)) * f32(1.0) \
            * (occ * words * t_bin / interval)
        e_ref = e_ref + refr * e_rw
    assert out["e_refresh_j"][0] == float(e_ref)


def test_sentinel_slot_prices_inf(own_table):
    tr = phase_trace(_one_slot(*PORT), "decode")
    out = simulate_traces(sim_cols(own_table),
                          np.array([[0], [-1]], np.int32), [tr], device=CPU)
    assert np.isfinite(out["e_total_j"][0])
    assert np.isinf(out["e_total_j"][1]) and np.isinf(out["t_sim_s"][1])
    assert out["collisions"][1] == 0.0
    assert np.isinf(out["phases"]["decode"]["e_total_j"][1])
    assert np.isfinite(out["phases"]["decode"]["e_total_j"][0])


# ----------------------------------------------- the grid against JAX, oracle
@pytest.mark.parametrize("policy", sorted(POLICIES))
def test_simulate_traces_matches_jax_on_the_same_columns(jtable, policy):
    """J = 41 compositions x S = 4 slots x 3 phases (2-3 for "short") on the
    JAX table's own columns, a sentinel row included."""
    kw = POLICIES[policy]
    phases = kw.get("phases", ("prefill", "decode", "train_step"))
    window = dict(duration_s=kw.get("duration_s", 1e-3),
                  n_bins=kw.get("n_bins", 32))
    idx = _grid(len(jtable))
    cols = {**jtable.metrics,
            "word_bits": np.asarray(jtable["word_size"], np.float64)}
    n = sim_eval_count()
    got = simulate_traces(cols, idx, task_traces(_task(*PORT), phases,
                                                 **window),
                          policy=SimPolicy(**kw), device=CPU)
    assert sim_eval_count() == n + 1
    want = jsimulate_traces(cols, idx, jtask_traces(_task(*JAX), phases,
                                                    **window),
                            policy=JSimPolicy(**kw))
    gaps = _sim_gaps(got, want)
    print(f"simulate_traces vs JAX ({policy}): max rel "
          f"{max(gaps.values()):.3e}")
    for m, gap in gaps.items():
        assert gap <= RTOL_SIM, (m, gap)
    assert np.isinf(got["e_total_j"][5])


@pytest.mark.parametrize("policy", ["default", "adaptive-drift", "expiry"])
def test_batched_replay_equals_the_oracle_bit_for_bit(own_table, policy):
    idx = _grid(len(own_table), seed=1)
    traces = task_traces(_task(*PORT), ("prefill", "decode", "train_step"))
    cols = sim_cols(own_table)
    kw = dict(policy=SimPolicy(**POLICIES[policy]), device=CPU)
    a = simulate_traces(cols, idx, traces, **kw)
    b = simulate_traces(cols, idx, traces, oracle=True, **kw)
    for m in SIM_METRICS:
        np.testing.assert_array_equal(a[m], b[m], err_msg=m)
    for phase in a["phases"]:
        for m in SIM_METRICS:
            np.testing.assert_array_equal(a["phases"][phase][m],
                                          b["phases"][phase][m],
                                          err_msg=f"{phase}/{m}")


def test_corner_retention_column_drives_the_replay():
    """``SimPolicy(corner="hot")`` schedules off ``retention_s@hot``: the
    same as JAX on the same corner columns, and more refresh than nominal."""
    space = japi.design_space(word_sizes=(16, 64), num_words=(32, 256))
    jt = japi.DesignTable.build(space, corners=["nominal", "hot"])
    cols = {**jt.metrics, "word_bits": np.asarray(jt["word_size"],
                                                  np.float64)}
    idx = np.random.default_rng(3).integers(0, len(jt), (16, 4)).astype(
        np.int32)
    traces = task_traces(_task(*PORT))
    got = simulate_traces(cols, idx, traces,
                          policy=SimPolicy(corner="hot"), device=CPU)
    want = jsimulate_traces(cols, idx, jtask_traces(_task(*JAX)),
                            policy=JSimPolicy(corner="hot"))
    for m, gap in _sim_gaps(got, want).items():
        assert gap <= RTOL_SIM, (m, gap)
    nominal = simulate_traces(cols, idx, traces, device=CPU)
    assert np.all(got["e_refresh_j"] >= nominal["e_refresh_j"])
    assert np.any(got["e_refresh_j"] > nominal["e_refresh_j"])
    with pytest.raises(KeyError, match="retention_s@cold"):
        simulate_traces(cols, idx, traces, policy=SimPolicy(corner="cold"),
                        device=CPU)


def test_robust_compose_refined_by_replay_on_a_corner_table():
    """``robust="worst_case"`` and ``refine="simulate"`` together on a
    corner table: the same re-ranked compositions as JAX's."""
    space = api.design_space(word_sizes=(16, 64), num_words=(32, 256))
    table = api.DesignTable.build(space, corners=["nominal", "hot"],
                                  device=CPU)
    jt = japi.DesignTable.build(
        japi.design_space(word_sizes=(16, 64), num_words=(32, 256)),
        corners=["nominal", "hot"])
    rep = compose(table, gainsight.TASKS[0], robust="worst_case",
                  refine="simulate", device=CPU)
    want = jcompose(jt, jgainsight.TASKS[0], robust="worst_case",
                    refine="simulate")
    assert rep.refined == "simulate" and rep.robust == "worst_case"
    print(f"robust re-rank: smallest adjacent sim_e_total_j gap "
          f"{_key_gap(rep):.3e}")
    np.testing.assert_array_equal(composition_idx(rep),
                                  jcomposition_idx(want))


# ------------------------------------------------------- simulate-then-rerank
def test_refine_simulate_reproduces_table2_in_jax_order(table, jtable):
    """7/7 through ``refine="simulate"``, and each task's re-ranked
    composition list equal to JAX's (rows, order, labels), metrics within
    ``RTOL_SIM``."""
    c = Compiler(device=CPU)
    gaps = []
    for t, jt in zip(gainsight.TASKS, jgainsight.TASKS):
        rep = c.simulate(t, space=table)
        want = jcompose(jtable, jt, refine="simulate")
        assert rep.refined == "simulate"
        assert rep.labels() == gainsight.TABLE2_EXPECTED[t.task_id]
        np.testing.assert_array_equal(composition_idx(rep),
                                      jcomposition_idx(want))
        assert [x.labels() for x in rep.ranked] == \
            [x.labels() for x in want.ranked]
        for got_c, want_c in zip(rep.ranked, want.ranked):
            for m in SIM_METRICS:
                assert _max_rel([got_c.metrics[f"sim_{m}"]],
                                [want_c.metrics[f"sim_{m}"]]) <= RTOL_SIM
        gaps.append(_key_gap(rep))
    print(f"Table 2 re-rank: smallest adjacent sim_e_total_j gap "
          f"{min(gaps):.3e}")
    assert sum(c.simulate(t, space=table).matches(
        gainsight.TABLE2_EXPECTED[t.task_id]) for t in gainsight.TASKS) == 7


def test_rerank_topk_containment(own_table):
    t = gainsight.TASKS[6]
    analytic = compose(own_table, t, device=CPU)
    refined = compose(own_table, t, refine="simulate", device=CPU)
    assert len(refined.ranked) == len(analytic.ranked)
    assert {tuple(r) for r in composition_idx(refined)} == \
        {tuple(r) for r in composition_idx(analytic)}
    for comp in refined.ranked:
        for m in SIM_METRICS:
            assert f"sim_{m}" in comp.metrics
    assert (refined.n_compositions, refined.n_feasible) == \
        (analytic.n_compositions, analytic.n_feasible)
    assert analytic.refined is None
    with pytest.raises(ValueError):
        compose(own_table, t, refine="nosuch", device=CPU)
    sharded = compose(own_table, t, refine="simulate", sharded=True,
                      device=CPU)
    assert composition_idx(sharded).tolist() == \
        composition_idx(refined).tolist()
    assert [c.metrics for c in sharded.ranked] == \
        [c.metrics for c in refined.ranked]


@pytest.mark.parametrize("objective", ["energy", "latency", "edp"])
def test_nlevel_power_rerank_matches_jax(table, jtable, objective):
    """The 3-level task under ``ComposePolicy(objective="power")``, where
    the simulated key replaces the analytic power and re-decides: the
    order equals JAX's exactly."""
    got = compose(table, gainsight.nlevel_task(3), refine="simulate",
                  compose_policy=ComposePolicy(objective="power"),
                  sim_policy=SimPolicy(objective=objective), device=CPU)
    want = jcompose(jtable, jgainsight.nlevel_task(3), refine="simulate",
                    compose_policy=JComposePolicy(objective="power"),
                    sim_policy=JSimPolicy(objective=objective))
    analytic = compose(table, gainsight.nlevel_task(3), device=CPU,
                       compose_policy=ComposePolicy(objective="power"))
    print(f"3-level power/{objective} re-rank: smallest adjacent "
          f"sim_e_total_j gap {_key_gap(got):.3e}")
    np.testing.assert_array_equal(composition_idx(got),
                                  jcomposition_idx(want))
    if objective == "energy":
        assert not np.array_equal(composition_idx(got),
                                  composition_idx(analytic))


def test_simulate_facade(own_table):
    rep = simulate(own_table, gainsight.TASKS[4], device=CPU)
    assert rep.refined == "simulate"
    assert rep.labels() == gainsight.TABLE2_EXPECTED[5]
    assert rep.best.metrics["sim_e_total_j"] > 0
    via_method = Compiler(device=CPU).simulate(gainsight.TASKS[4],
                                               space=own_table)
    assert via_method.labels() == rep.labels()
    assert [c.metrics for c in via_method.ranked] == \
        [c.metrics for c in rep.ranked]


def test_sim_cache_hits_and_key_sensitivity(own_table, tmp_path):
    """A cached simulate() re-runs neither the analytic scoring nor the
    trace replay (the table cache is the caller's: a pre-built table);
    changing the sim policy or the task misses."""
    c = Compiler(device=CPU)
    t = gainsight.TASKS[1]
    r1 = c.simulate(t, space=own_table, cache=tmp_path)
    assert len(list(tmp_path.glob("sim_*.npz"))) == 1
    n_comp, n_sim = composition_eval_count(), sim_eval_count()
    r2 = c.simulate(t, space=own_table, cache=tmp_path)
    assert composition_eval_count() == n_comp
    assert sim_eval_count() == n_sim
    assert composition_idx(r2).tolist() == composition_idx(r1).tolist()
    assert [x.metrics for x in r2.ranked] == [x.metrics for x in r1.ranked]
    c.simulate(t, space=own_table, cache=tmp_path,
               sim_policy=SimPolicy(n_bins=8))
    assert sim_eval_count() == n_sim + 1
    assert composition_eval_count() == n_comp
    c.simulate(gainsight.TASKS[3], space=own_table, cache=tmp_path)
    assert sim_eval_count() == n_sim + 2
    assert composition_eval_count() == n_comp + 1


def test_sim_cache_through_the_table_cache(tmp_path):
    """The whole flow from a cache directory on a small grid: the repeat
    runs no characterization, scoring or replay."""
    c = Compiler(device=CPU)
    space = api.design_space(word_sizes=(16, 64), num_words=(32, 256))
    r1 = c.simulate(gainsight.TASKS[0], space=space, cache=tmp_path)
    counts = (api.characterize_call_count(), composition_eval_count(),
              sim_eval_count())
    r2 = c.simulate(gainsight.TASKS[0], space=space, cache=tmp_path)
    assert (api.characterize_call_count(), composition_eval_count(),
            sim_eval_count()) == counts
    assert r2.labels() == r1.labels()


def test_cold_boost_scenario_prices_swept_levels(own_table, jtable):
    """The same GC macro replayed at the base point and at the (1.2 V,
    233 K) block under the adaptive controller and a 30 K drift: the cold
    block's longer retention cuts refresh energy, the port equals JAX
    within ``RTOL_SIM`` and its oracle bit for bit."""
    def scenario(table, corners_mod, expand_mod, **kw):
        pts = ((None, None),
               (corners_mod.as_operating_point((1.2, 233.0)), None))
        metrics, fams = expand_mod.expand_metrics(table, table.metrics, pts,
                                                  **kw)
        n = len(table)
        gc = int(np.where((np.asarray(fams[:n]) != "sram6t")
                          & (np.asarray(metrics["retention_s"][:n])
                             < 1e-3))[0][0])
        assert metrics["retention_s"][n + gc] > metrics["retention_s"][gc]
        cols = {k: np.asarray(metrics[k]) for k in
                ("bits", "e_read_j", "e_write_j", "f_op_hz", "p_leak_w",
                 "retention_s")}
        cols["word_bits"] = np.tile(np.asarray(table["word_size"],
                                               np.float64), 2)
        return cols, np.array([[gc], [n + gc]], np.int32)

    cols, idx = scenario(own_table, corners, expand, device=CPU)
    jcols, jidx = scenario(jtable, jcorners, jexpand)
    np.testing.assert_array_equal(idx, jidx)
    kw = dict(refresh=True, adaptive_refresh=True, temp_drift_k=30.0)
    trace = [phase_trace(_one_slot(*PORT, cap_bits=1 << 20), "decode",
                         1e-3, 16)]
    out = simulate_traces(cols, idx, trace, policy=SimPolicy(**kw),
                          device=CPU)
    assert np.all(np.isfinite(out["e_total_j"]))
    assert out["e_refresh_j"][1] < out["e_refresh_j"][0]
    ora = simulate_traces(cols, idx, trace, policy=SimPolicy(**kw),
                          device=CPU, oracle=True)
    for m in SIM_METRICS:
        np.testing.assert_array_equal(out[m], ora[m], err_msg=m)
    want = jsimulate_traces(jcols, jidx, [jphase_trace(
        _one_slot(*JAX, cap_bits=1 << 20), "decode", 1e-3, 16)],
        policy=JSimPolicy(**kw))
    # own columns on both sides (each package's table): the columns' own
    # parity (2e-6) bounds what the replay can add to it
    for m, gap in _sim_gaps(out, want).items():
        assert gap <= RTOL_SIM, (m, gap)


if __name__ == "__main__":
    jt = japi.DesignTable.from_configs(japi.design_space())
    cols = {**jt.metrics, "word_bits": np.asarray(jt["word_size"],
                                                  np.float64)}
    idx = _grid(len(jt))
    for name, kw in POLICIES.items():
        phases = kw.get("phases", ("prefill", "decode", "train_step"))
        window = dict(duration_s=kw.get("duration_s", 1e-3),
                      n_bins=kw.get("n_bins", 32))
        got = simulate_traces(cols, idx, task_traces(_task(*PORT), phases,
                                                     **window),
                              policy=SimPolicy(**kw), device=CPU)
        want = jsimulate_traces(cols, idx, jtask_traces(_task(*JAX), phases,
                                                        **window),
                                policy=JSimPolicy(**kw))
        gaps = _sim_gaps(got, want)
        worst = max(gaps, key=gaps.get)
        print(f"simulate_traces vs JAX, J=41 S=4, {name}: max rel "
              f"{gaps[worst]:.3e} ({worst}; gate {RTOL_SIM})")
    own = api.DesignTable.build(device=CPU)
    for label, tab in (("own table", own), ("JAX table", convert.table_from_numpy(
            {k: jt[k] for k in jt.AXIS_NAMES}, jt.metrics))):
        gaps, same = [], 0
        for t, jtask in zip(gainsight.TASKS, jgainsight.TASKS):
            rep = compose(tab, t, refine="simulate", device=CPU)
            want = jcompose(jt, jtask, refine="simulate")
            same += np.array_equal(composition_idx(rep),
                                   jcomposition_idx(want))
            gaps.append(_key_gap(rep))
        print(f"Table 2 re-rank ({label}): {same}/7 orders equal to JAX, "
              f"smallest adjacent key gap {min(gaps):.3e}")
