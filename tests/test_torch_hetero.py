"""``repro_torch.hetero`` (joint N-level composition) on the CPU against the
JAX reference: the scorer, the candidate lists, branch-and-bound, Table 2
through ``compose``, the N-level and vdd-sweep goldens, corner-robust
composition and the report cache.

Discrete results (labels, picks, tiles, operating points, ``n_space``,
``search``, ``n_compositions``) are compared exactly. Metrics of the best
composition against the goldens and live JAX: rtol ``RTOL_METRICS``."""
import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

from repro import api as japi
from repro.core import gainsight as jgainsight
from repro.hetero import ComposePolicy as JComposePolicy
from repro.hetero import SystemBudget as JSystemBudget
from repro.hetero import candidates as jcandidates
from repro.hetero import compose as jcompose
from repro.hetero import system as jsystem
from repro_torch import api, convert
from repro_torch.core import gainsight
from repro_torch.hetero import (ComposePolicy, SystemBudget, candidates,
                                compose, composition_eval_count, system)

GOLDEN = Path(__file__).resolve().parent / "golden"
VDD_SWEEP_POINT = (1.2, 233.0)
# the settings tests/golden/table2_nlevel.json freezes
NLEVEL_POLICIES = {
    "preference": dict(),
    "power_bb": dict(objective="power", candidate_mode="all_feasible",
                     search="branch_and_bound"),
}
# the best composition's float32 system metrics against the goldens and
# live JAX. Measured: 0 (the port's sums add the slots in the reference's
# order, over characterized columns within 2e-6 of it); the golden's task-3
# swept p_w is one float32 ulp (6e-8) from live JAX 0.9 itself.
RTOL_METRICS = 1e-5
OBJECTIVES = ("preference", "power", "area", "balanced")


def _picks(report):
    return {lvl: [[p.family, p.config_idx,
                   p.op.corner if p.op is not None else None,
                   p.refresh_margin] for p in lc.picks]
            for lvl, lc in report.best.levels.items()}


def _ranked(report):
    """Every ranked composition as comparable plain values."""
    return [(c.labels(), {lvl: [(p.family, p.config_idx,
                                 p.op.corner if p.op is not None else None,
                                 p.refresh_margin) for p in lc.picks]
                          for lvl, lc in c.levels.items()},
             {lvl: list(lc.tiles) for lvl, lc in c.levels.items()},
             c.pref_rank, c.feasible) for c in report.ranked]


def _assert_metrics_close(got, want):
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=RTOL_METRICS, atol=0,
                                   err_msg=k)


@pytest.fixture(scope="module")
def jtable():
    return japi.DesignTable.from_configs(japi.design_space())


@pytest.fixture(scope="module")
def own_table():
    return api.DesignTable.build(device="cpu")


@pytest.fixture(scope="module")
def carried(jtable):
    """The JAX table's columns carried into a port DesignTable."""
    return convert.table_from_numpy(
        {k: jtable[k] for k in jtable.AXIS_NAMES}, jtable.metrics,
        [(op.vdd, op.temp_k, op.corner) for op in jtable.corners])


@pytest.fixture(scope="module", params=["carried", "own"])
def table(request, carried, own_table):
    return carried if request.param == "carried" else own_table


# ------------------------------------------------------------------ scorer
def _random_grid(S, seed, n=300, J=2000):
    rng = np.random.default_rng(seed)
    cols = {k: (10.0 ** rng.uniform(-12, 8, n)).astype(np.float32)
            for k in system.METRIC_COLS}
    cols["bits"] = np.floor(10.0 ** rng.uniform(0, 6, n)).astype(np.float32)
    idx = rng.integers(0, n, (J, S)).astype(np.int32)
    idx[rng.random((J, S)) < 0.1] = -1
    return (cols, idx, np.floor(10.0 ** rng.uniform(3, 9, S)),
            10.0 ** rng.uniform(7, 10, S))


@pytest.mark.parametrize("S", [1, 2, 3, 5, 8])
def test_score_kernel_matches_jax(S):
    """Random (J, S) grids with -1 sentinels, float32 columns over 20
    decades: every metric equal to the reference's jitted ``score_kernel``.
    At S = 1 only ``p_w`` may differ, by at most one float32 ulp: XLA folds
    the one-slot sums and contracts p_static + e_read·f into an FMA."""
    cols, idx, cap_bits, f_req = _random_grid(S, seed=S)
    want = jsystem._score_jit(
        jnp.asarray(idx), {k: jnp.asarray(v) for k, v in cols.items()},
        jnp.asarray(cap_bits, jnp.float32), jnp.asarray(f_req, jnp.float32))
    n = composition_eval_count()
    got = system.score_grid(cols, idx, cap_bits, f_req, device="cpu")
    assert composition_eval_count() == n + 1
    for k in system.SYSTEM_METRICS:
        assert got[k].dtype == np.float32 and got[k].shape == (len(idx),)
        if S == 1 and k == "p_w":
            np.testing.assert_allclose(got[k], np.asarray(want[k]),
                                       rtol=2.0 ** -23, atol=0)
        else:
            np.testing.assert_array_equal(got[k], np.asarray(want[k]),
                                          err_msg=k)
    np.testing.assert_array_equal(
        system.tiles_for(cols, idx, cap_bits),
        jsystem.tiles_for(cols, idx, cap_bits))


def test_score_grid_corners_matches_jax():
    cols, idx, cap_bits, f_req = _random_grid(3, seed=11)
    rng = np.random.default_rng(12)
    per_corner = [{k: (v * rng.uniform(0.5, 2.0, v.shape)).astype(np.float32)
                   for k, v in cols.items()} for _ in range(3)]
    got = system.score_grid_corners(per_corner, idx, cap_bits, f_req,
                                    device="cpu")
    want = jsystem.score_grid_corners(per_corner, idx, cap_bits, f_req)
    for k in system.SYSTEM_METRICS:
        assert got[k].shape == (3, len(idx))
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    sharded = system.score_grid(cols, idx, cap_bits, f_req, sharded=True,
                                device="cpu")      # one device: plain call
    plain = system.score_grid(cols, idx, cap_bits, f_req, device="cpu")
    for k in system.SYSTEM_METRICS:
        np.testing.assert_array_equal(sharded[k], plain[k], err_msg=k)


# -------------------------------------------------------------- candidates
@pytest.mark.parametrize("mode", ["per_family_best", "all_feasible"])
def test_candidates_equal_jax(carried, jtable, mode):
    tasks = [(t, jt) for t, jt in zip(gainsight.TASKS, jgainsight.TASKS)]
    tasks.append((gainsight.nlevel_task(5), jgainsight.nlevel_task(5)))
    metrics = carried.metrics
    for task, jtask in tasks:
        ptask = api.as_task_req(task)
        jtreq = japi.as_task_req(jtask)
        for name, level in ptask.levels.items():
            for order_by in OBJECTIVES:
                for ensure in ((), ("area", "power", "bandwidth")):
                    kw = dict(mode=mode, max_per_bucket=16,
                              order_by=order_by, ensure_orders=ensure)
                    got = candidates.level_candidates(
                        metrics, carried.families, level, **kw)
                    want = jcandidates.level_candidates(
                        jtable.metrics, jtable.families,
                        jtreq.levels[name], **kw)
                    assert [(c.family, c.config_idx, c.pref_rank)
                            for bc in got for c in bc.candidates] == \
                        [(c.family, c.config_idx, c.pref_rank)
                         for bc in want for c in bc.candidates]
                    assert [(bc.capacity_bits, bc.capped, bc.pinned)
                            for bc in got] == \
                        [(bc.capacity_bits, bc.capped, bc.pinned)
                         for bc in want]


# -------------------------------------------------------- branch-and-bound
BB_TASKS = {"task1": lambda g: g.TASKS[0], "task3": lambda g: g.TASKS[2],
            "nlevel2": lambda g: g.nlevel_task(2)}


@pytest.mark.parametrize("objective", OBJECTIVES)
@pytest.mark.parametrize("task", sorted(BB_TASKS))
def test_branch_and_bound_rank_identical_to_exhaustive(carried, jtable, task,
                                                       objective):
    """Over every feasible row: the port's branch-and-bound ranks its top
    5 exactly as the port's exhaustive grid does, and scores as many
    compositions as the reference's branch-and-bound."""
    kw = dict(candidate_mode="all_feasible", objective=objective, top_k=5)
    t, jt = BB_TASKS[task](gainsight), BB_TASKS[task](jgainsight)
    ex = compose(carried, t, compose_policy=ComposePolicy(
        search="exhaustive", **kw), device="cpu")
    bb = compose(carried, t, compose_policy=ComposePolicy(
        search="branch_and_bound", **kw), device="cpu")
    jbb = jcompose(jtable, jt, compose_policy=JComposePolicy(
        search="branch_and_bound", **kw))
    assert ex.n_space == bb.n_space == jbb.n_space
    assert ex.n_compositions == ex.n_space
    assert bb.search == "branch_and_bound" and ex.search == "exhaustive"
    assert bb.n_compositions == jbb.n_compositions < ex.n_compositions
    assert _ranked(bb) == _ranked(ex) == _ranked(jbb)
    assert [c.metrics for c in bb.ranked] == [c.metrics for c in ex.ranked]


def test_budgeted_composition_matches_jax(carried, jtable):
    budget = dict(area_um2=2.5e6, power_w=0.05, bw_margin_min=1.0)
    for t, jt in zip(gainsight.TASKS, jgainsight.TASKS):
        got = compose(carried, t, compose_policy=ComposePolicy(
            objective="power", candidate_mode="all_feasible",
            budget=SystemBudget(**budget)), device="cpu")
        want = jcompose(jtable, jt, compose_policy=JComposePolicy(
            objective="power", candidate_mode="all_feasible",
            budget=JSystemBudget(**budget)))
        assert _ranked(got) == _ranked(want), t.task_id
        assert (got.n_feasible, got.truncated) == \
            (want.n_feasible, want.truncated)


# ------------------------------------------------------------------ Table 2
def test_table2_through_compose(table):
    for t in gainsight.TASKS:
        rep = compose(table, t, device="cpu")
        assert rep.labels() == gainsight.TABLE2_EXPECTED[t.task_id]
        assert rep.matches(gainsight.TABLE2_EXPECTED[t.task_id])
        via = compose(table, t, levels=("L1", "L2"), device="cpu")
        assert via.labels() == rep.labels()
    with pytest.raises(KeyError):
        compose(table, gainsight.TASKS[0], levels=("L3",), device="cpu")


# ---------------------------------------------------------------- goldens
@pytest.fixture(scope="module")
def nlevel_golden():
    return json.loads((GOLDEN / "table2_nlevel.json").read_text())


@pytest.fixture(scope="module")
def vdd_golden():
    return json.loads((GOLDEN / "table2_vdd.json").read_text())


@pytest.mark.parametrize("policy", sorted(NLEVEL_POLICIES))
def test_nlevel_golden_and_live_jax(table, jtable, nlevel_golden, policy):
    rep = compose(table, gainsight.nlevel_task(3), device="cpu",
                  compose_policy=ComposePolicy(**NLEVEL_POLICIES[policy]))
    live = jcompose(jtable, jgainsight.nlevel_task(3),
                    compose_policy=JComposePolicy(**NLEVEL_POLICIES[policy]))
    want = nlevel_golden["compositions"][policy]
    best = rep.best
    assert best.labels() == want["labels"] == live.best.labels()
    assert {lvl: [p.config_idx for p in lc.picks]
            for lvl, lc in best.levels.items()} == want["picks"]
    assert {lvl: list(lc.tiles) for lvl, lc in best.levels.items()} == \
        want["tiles"]
    assert (rep.n_space, rep.search) == (want["n_space"], want["search"])
    assert (rep.n_space, rep.search, rep.n_compositions) == \
        (live.n_space, live.search, live.n_compositions)
    assert _ranked(rep) == _ranked(live)
    _assert_metrics_close(best.metrics, want["metrics"])
    _assert_metrics_close(best.metrics, live.best.metrics)


def test_vdd_sweep_golden_and_live_jax(table, jtable, vdd_golden):
    """The cold-boost point (1.2 V, 233 K) flips tasks 1, 2, 4 and 6 to
    OS-Si; picks carry the point's label and the physical row."""
    assert vdd_golden["vdd_sweep_point"] == list(VDD_SWEEP_POINT)
    flipped = []
    for t, jt in zip(gainsight.TASKS, jgainsight.TASKS):
        want = vdd_golden["tasks"][str(t.task_id)]
        base = compose(table, t, device="cpu")
        swept = compose(table, t, device="cpu", compose_policy=ComposePolicy(
            vdd_sweep=(VDD_SWEEP_POINT,)))
        live = jcompose(jtable, jt, compose_policy=JComposePolicy(
            vdd_sweep=(VDD_SWEEP_POINT,)))
        assert base.labels() == want["base_labels"], t.task_id
        assert swept.labels() == want["swept_labels"] == live.labels()
        assert _picks(swept) == want["picks"] == _picks(live), t.task_id
        assert _ranked(swept) == _ranked(live), t.task_id
        np.testing.assert_allclose(base.best.metrics["p_w"],
                                   want["p_w"]["base"], rtol=RTOL_METRICS)
        np.testing.assert_allclose(swept.best.metrics["p_w"],
                                   want["p_w"]["swept"], rtol=RTOL_METRICS)
        _assert_metrics_close(swept.best.metrics, live.best.metrics)
        if swept.labels() != base.labels():
            flipped.append(t.task_id)
    assert flipped == [1, 2, 4, 6]


def test_margin_sweep_and_swept_pick_macro(own_table, jtable):
    """A crossed (vdd, refresh-margin) sweep ranks as the reference's does,
    and a swept pick's macro is priced at its operating point."""
    cp = dict(vdd_sweep=(VDD_SWEEP_POINT, 0.9), refresh_margin_sweep=(0.8,),
              candidate_mode="all_feasible", objective="power", top_k=4)
    got = compose(own_table, gainsight.TASKS[2], device="cpu",
                  compose_policy=ComposePolicy(**cp))
    want = jcompose(jtable, jgainsight.TASKS[2],
                    compose_policy=JComposePolicy(**cp))
    assert _ranked(got) == _ranked(want)
    pick = got.best.levels["L1"].picks[0]
    macro = got.pick_macro("L1", device="cpu")
    assert macro.config == own_table.config(pick.config_idx)
    if pick.op is not None:
        assert macro.ppa != own_table.macro(pick.config_idx).ppa


# ------------------------------------------------------------- robustness
def test_robust_compose_matches_jax():
    corners = ["nominal", "hot", "cold", "low_vdd"]
    space = api.design_space(word_sizes=(16, 64), num_words=(32, 256))
    got_table = api.DesignTable.build(space, corners=corners, device="cpu")
    want_table = japi.DesignTable.build(
        japi.design_space(word_sizes=(16, 64), num_words=(32, 256)),
        corners=corners)
    for t, jt in zip(gainsight.TASKS, jgainsight.TASKS):
        got = compose(got_table, t, robust="worst_case", device="cpu")
        want = jcompose(want_table, jt, robust="worst_case")
        assert got.robust == "worst_case"
        assert _ranked(got) == _ranked(want), t.task_id
    with pytest.raises(ValueError, match="worst_case"):
        compose(got_table, gainsight.TASKS[0], robust="worst_case",
                compose_policy=ComposePolicy(vdd_sweep=(0.9,)),
                device="cpu")


def test_compose_policy_validation_matches_jax():
    cp = ComposePolicy(vdd_sweep=(0.9, "hot", (1.2, 233.0)))
    assert [p.corner for p in cp.vdd_sweep] == \
        ["v0.9_t300", "hot", "v1.2_t233"]
    with pytest.raises(ValueError, match="collide"):
        ComposePolicy(vdd_sweep=(0.9, (0.9, 300.0)))
    for bad in (0.0, -0.5, 1.5, float("nan")):
        with pytest.raises(ValueError, match="refresh_margin_sweep"):
            ComposePolicy(refresh_margin_sweep=(bad,))
    with pytest.raises(ValueError, match="objective"):
        ComposePolicy(objective="speed")
    with pytest.raises(ValueError, match="not both"):
        ComposePolicy(budget=SystemBudget(area_um2=1.0), power_budget_w=1.0)


# ------------------------------------------------------------------- cache
def test_report_cache_round_trip(own_table, tmp_path):
    """A repeat compose() with the same inputs is a hit (no scoring) and
    rebuilds the swept picks, tiles and metrics exactly; a changed sweep
    misses."""
    t = gainsight.TASKS[0]
    cp = ComposePolicy(vdd_sweep=(VDD_SWEEP_POINT,),
                       refresh_margin_sweep=(0.8,))
    first = compose(own_table, t, cache=tmp_path, compose_policy=cp,
                    device="cpu")
    assert len(list(tmp_path.glob("hetero_*.npz"))) == 1
    n = composition_eval_count()
    again = compose(own_table, t, cache=tmp_path, compose_policy=cp,
                    device="cpu")
    assert composition_eval_count() == n
    assert _ranked(again) == _ranked(first)
    assert [c.metrics for c in again.ranked] == \
        [c.metrics for c in first.ranked]
    assert (again.n_space, again.search, again.n_compositions) == \
        (first.n_space, first.search, first.n_compositions)
    compose(own_table, t, cache=tmp_path, device="cpu",
            compose_policy=ComposePolicy(vdd_sweep=(VDD_SWEEP_POINT,)))
    assert composition_eval_count() == n + 1
