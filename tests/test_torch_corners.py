"""Operating corners in the PyTorch port (on the CPU) against the JAX
reference: TechParams, ``characterize_corners`` at hot, cold, low-vdd and
the cold-boost point (1.2 V, 233 K), ``retention_time_batch`` at each
corner, the read-margin threshold at other supplies, corner DesignTables
and robust ``explore``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.core import bitcells as jbitcells
from repro.core import characterize as jchz
from repro.core import corners as jcorners
from repro.core import retention as jretention
from repro_torch import api
from repro_torch.core import bitcells, corners, retention
from repro_torch.core import characterize as chz
from repro_torch.kernels import retention as kretention

# float32 metrics and retention vs live JAX at every corner: worst relative
# gap measured by running this file (``python tests/test_torch_corners.py``)
# is 1.02e-6 (retention of the level-shifted cells at hot), 5.8e-7 for the
# other columns. Causes (ROADMAP.md §3): the retention kernel folds
# drive_scale into ispec, leak_scale into i_floor and jg, and divides jg by
# vdd before it multiplies by V, where the reference's solver scales after
# the difference and takes j_gate·w·(V/vdd); XLA reassociates constants in
# the jitted characterize. The nominal gate of the earlier slices.
RTOL = 2e-6
# the corners of the parity checks: the four named ones and the vdd sweep's
# cold-boost point
OPS = ("nominal", "hot", "cold", "low_vdd", (1.2, 233.0))
NAMES = jbitcells.MEM_TYPE_ORDER


def _id(op):
    return op if isinstance(op, str) else "v{:g}_t{:g}".format(*op)


def _jax_tp(op):
    return jcorners.resolve(jcorners.as_operating_point(op))


def _port_tp(op):
    return corners.resolve(corners.as_operating_point(op))


def max_rel(got, want):
    """Largest |got - want| / |want| over a column (0/0 counts as 0)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    diff = np.abs(got - want)
    return float(np.max(np.where(diff == 0, 0.0,
                                 diff / np.maximum(np.abs(want), 1e-300))))


def characterize_both(space, ops=OPS):
    """(port, JAX) dicts of (N, C) numpy columns of ``space`` at ``ops``."""
    vecs = np.asarray(jnp.stack([c.to_vector() for c in space]))
    want = {k: np.asarray(v) for k, v in
            jchz.characterize_corners(jnp.asarray(vecs), ops).items()}
    got = {k: v.numpy() for k, v in chz.characterize_corners(
        torch.from_numpy(vecs.copy()), ops, device="cpu").items()}
    return got, want


# the 20-row slice that tests/golden/table2.json freezes
SLICE_KW = dict(word_sizes=(16, 64), num_words=(32, 256))
GRIDS = {"paper-120": {}, "golden-slice-20": SLICE_KW}


@pytest.fixture(scope="module")
def grids():
    return {name: characterize_both(japi.design_space(**kw))
            for name, kw in GRIDS.items()}


@pytest.fixture(scope="module")
def tables():
    """The paper grid at every corner of OPS, built by each package."""
    space = japi.design_space()
    return (api.DesignTable.build(api.design_space(), corners=OPS,
                                  device="cpu"),
            japi.DesignTable.build(space, corners=OPS))


# ------------------------------------------------------------- TechParams
@pytest.mark.parametrize("op", OPS, ids=_id)
def test_tech_params_match_the_reference(op):
    got, want = _port_tp(op), _jax_tp(op)
    assert got._fields == want._fields
    assert tuple(got) == tuple(want)          # python floats, bit for bit
    assert corners.as_operating_point(op).fingerprint() == \
        jcorners.as_operating_point(op).fingerprint()


def test_stack_tech_and_fingerprint_match_the_reference():
    got = corners.stack_tech(OPS)
    want = jcorners.stack_tech(OPS)
    for f in corners.TechParams._fields:
        t = getattr(got, f)
        assert t.dtype == torch.float32 and t.shape == (len(OPS),)
        np.testing.assert_array_equal(t.numpy(), np.asarray(getattr(want, f)),
                                      err_msg=f)
    for ops in (("nominal",), OPS, ("hot", "cold")):
        assert corners.corners_fingerprint(corners.as_corners(ops)) == \
            jcorners.corners_fingerprint(jcorners.as_corners(ops))
    assert corners.corners_fingerprint((corners.NOMINAL,)) == ""


# ---------------------------------------------------- characterize_corners
@pytest.mark.parametrize("grid", sorted(GRIDS))
def test_characterize_corners_matches_jax(grids, grid):
    got, want = grids[grid]
    assert sorted(got) == sorted(want)
    n = len(japi.design_space(**GRIDS[grid]))
    for k in want:
        assert got[k].shape == want[k].shape == (n, len(OPS)), k
        for c, op in enumerate(OPS):
            gap = max_rel(got[k][:, c], want[k][:, c])
            assert gap <= RTOL, (k, _id(op), gap)
    for k in ("rows", "cols", "mux", "bits"):
        np.testing.assert_array_equal(got[k], want[k])


def test_each_corner_column_is_that_corner_characterized_alone(grids):
    """A corner's column of ``characterize_corners`` is what
    ``characterize_config`` gives at that corner, as in the reference."""
    got, _ = grids["golden-slice-20"]
    cfg = api.design_space(**SLICE_KW)[7]
    for c, op in enumerate(OPS):
        alone = chz.characterize_config(
            cfg, tp=corners.as_operating_point(op), device="cpu")
        for k, v in alone.items():
            assert np.float32(v) == got[k][7, c], (k, _id(op))


def test_corners_move_the_physics_the_expected_way(grids):
    got, _ = grids["paper-120"]
    gc = np.array([c.mem_type != "sram6t" for c in japi.design_space()])
    ret = got["retention_s"]
    nom, hot, cold = (OPS.index(o) for o in ("nominal", "hot", "cold"))
    assert (ret[gc, hot] < ret[gc, nom]).all()
    assert (ret[gc, cold] > ret[gc, nom]).all()


# ------------------------------------------------- retention_time_batch
@pytest.mark.parametrize("ls", [0, 1])
@pytest.mark.parametrize("op", OPS, ids=_id)
def test_retention_time_batch_at_corner_matches_reference_solver(op, ls):
    """All 7 cells: the kernel path (plain version on the CPU) at the
    corner's thermal voltage against the reference's ``retention_time``;
    start-crossed rows (HVT write device without a level shifter) exact."""
    jtp = _jax_tp(op)
    cells = [jbitcells.BITCELLS[n] for n in NAMES]
    stacked = jax.tree.map(lambda *x: jnp.stack(x), *cells)
    want = np.asarray(jax.jit(jax.vmap(
        lambda c: jretention.retention_time(c, ls, jtp)))(stacked))
    got = retention.retention_time_batch(
        bitcells.stack_bitcells(), torch.full((7,), float(ls)),
        _port_tp(op)).numpy()
    assert max_rel(got, want) <= RTOL
    params = retention.pack_retention_params(
        bitcells.stack_bitcells(), torch.full((7,), float(ls)), _port_tp(op))
    start = (params[:, 8] < params[:, 9]).numpy()
    assert start.any() == (ls == 0)
    np.testing.assert_array_equal(got[start], want[start])
    assert (got[start] < 2e-9).all()


def test_kernel_takes_the_corner_thermal_voltage():
    """The plain kernel version at a corner's ``ut`` differs from the
    nominal one (hot: faster decay), and the float32 pair a launch passes
    keeps the nominal bits: ``1.0f / 0.02585f``."""
    ut, inv_ut = kretention.thermal_voltage_args(kretention.UT)
    assert np.float32(inv_ut) == np.float32(1.0) / np.float32(0.02585)
    assert np.float32(ut) == np.float32(0.02585)
    hot = corners.TechParams.from_op(corners.HOT)
    params = retention.pack_retention_params(
        bitcells.stack_bitcells(), torch.ones(7), hot)
    ts = retention.time_grid()
    at_hot = kretention.retention_batch(params, ts, hot.ut)
    at_nominal_ut = kretention.retention_batch(params, ts)
    assert (at_hot < at_nominal_ut).all()
    with pytest.raises(ValueError, match="thermal voltage"):
        kretention.retention_batch(params, ts, 0.0)


@pytest.mark.parametrize("vdd", [0.9, 1.1, 1.2])
def test_read_margin_threshold_grid_matches_jax_exactly(vdd):
    """The threshold is a grid point of linspace(0, vdd, 256): the port's
    grid equals jnp.linspace eager and under jit, and every cell's
    threshold equals the reference's at 300 K and 233 K."""
    grid = retention._linspace_f32(0.0, vdd, 256)
    np.testing.assert_array_equal(grid, np.asarray(jnp.linspace(0.0, vdd,
                                                                256)))
    np.testing.assert_array_equal(grid, np.asarray(jax.jit(
        lambda: jnp.linspace(0.0, vdd, 256))()))
    for temp_k in (300.0, 233.0):
        op = (vdd, temp_k)
        got = retention.read_margin_threshold(bitcells.stack_bitcells(),
                                              tp=_port_tp(op)).numpy()
        want = np.array([float(jretention.read_margin_threshold(
            jbitcells.BITCELLS[n], tp=_jax_tp(op))) for n in NAMES],
            np.float32)
        np.testing.assert_array_equal(got, want)


# ------------------------------------------------------- corner tables
def test_corner_table_columns_match_jax(tables):
    got, want = tables
    assert got.corner_labels == want.corner_labels == \
        ("nominal", "hot", "cold", "low_vdd", "v1.2_t233")
    assert sorted(got.metric_names) == sorted(want.metric_names)
    for k in want.metric_names:
        assert max_rel(got[k], want[k]) <= RTOL, k
    for label in want.corner_labels:
        g, w = got.corner_metrics(label), want.corner_metrics(label)
        assert sorted(g) == sorted(w)
        for k in w:
            assert max_rel(g[k], w[k]) <= RTOL, (label, k)
    with pytest.raises(KeyError):
        got.corner_metrics("warm")


def test_worst_case_metrics_match_jax(tables):
    got, want = tables
    g, w = got.worst_case_metrics(), want.worst_case_metrics()
    assert sorted(g) == sorted(w)
    for k in w:
        assert max_rel(g[k], w[k]) <= RTOL, k
    assert got.robust_metrics(None).keys() == got.metrics.keys()
    with pytest.raises(ValueError, match="robust mode"):
        got.robust_metrics("best_case")
    # a derived column has no per-corner variants and passes through
    derived = got.with_column("area_x2", 2 * got["area_um2"])
    np.testing.assert_array_equal(derived.worst_case_metrics()["area_x2"],
                                  2 * got["area_um2"])
    assert derived.corners == got.corners


def test_corner_table_save_load_round_trip(tables, tmp_path):
    got, _ = tables
    path = got.save(tmp_path / "t.npz")
    back = api.DesignTable.load(path)
    assert back.corners == got.corners
    assert back.grid_hash == got.grid_hash
    for k in got.columns:
        np.testing.assert_array_equal(back[k], got[k])


def test_grid_hash_is_corner_sensitive_and_cache_hits(tmp_path):
    space = api.design_space(word_sizes=(16,), num_words=(32, 64))
    hashes = {api.grid_hash(space), api.grid_hash(space, corners=["hot"]),
              api.grid_hash(space, corners=["nominal", "hot"]),
              api.grid_hash(space, corners=["hot", "nominal"])}
    assert len(hashes) == 4
    assert api.grid_hash(space, corners=["nominal"]) == api.grid_hash(space)
    first = api.DesignTable.build(space, cache=tmp_path,
                                  corners=["nominal", "hot"], device="cpu")
    assert first.grid_hash == api.grid_hash(space,
                                            corners=["nominal", "hot"])
    n = api.characterize_call_count()
    again = api.DesignTable.build(space, cache=tmp_path,
                                  corners=["nominal", "hot"], device="cpu")
    assert api.characterize_call_count() == n
    assert again.corner_labels == ("nominal", "hot")
    api.DesignTable.build(space, cache=tmp_path, corners=["hot"],
                          device="cpu")
    assert api.characterize_call_count() == n + 1
    with pytest.raises(ValueError, match="conflicts"):
        api.DesignTable.build(first, corners=["cold"], device="cpu")
    assert api.DesignTable.build(first, corners=["nominal", "hot"],
                                 device="cpu") is first


def test_robust_explore_labels_match_jax(tables):
    got_table, want_table = tables
    got = api.explore(got_table, robust="worst_case", device="cpu")
    want = japi.explore(want_table, robust="worst_case")
    assert got.robust == want.robust == "worst_case"
    assert got.labels() == want.labels()
    for tid, levels in want.selections.items():
        for lvl, sel in levels.items():
            assert [(p.family, p.config_idx)
                    for p in got.selections[tid][lvl].picks] == \
                [(p.family, p.config_idx) for p in sel.picks], (tid, lvl)
    # the base (corners[0] = nominal) columns still give the paper's Table 2
    assert api.explore(got_table, device="cpu").labels() == \
        japi.explore(want_table).labels()
    macro = got.pick_macro(1, "L1")
    assert macro.config == got_table.config(
        got.selections[1]["L1"].picks[0].config_idx)


if __name__ == "__main__":
    # the measurements behind RTOL: worst gap per grid and corner
    for name, kw in sorted(GRIDS.items()):
        got, want = characterize_both(japi.design_space(**kw))
        for c, op in enumerate(OPS):
            worst = {k: max_rel(got[k][:, c], want[k][:, c]) for k in want}
            k = max(worst, key=worst.get)
            print(f"{name} at {_id(op)}: worst max rel {worst[k]:.3e} ({k}), "
                  f"retention {worst['retention_s']:.3e}")
    for op in OPS:
        for ls in (0, 1):
            cells = [jbitcells.BITCELLS[n] for n in NAMES]
            want = np.array([float(jretention.retention_time(
                c, ls, _jax_tp(op))) for c in cells], np.float32)
            got = retention.retention_time_batch(
                bitcells.stack_bitcells(), torch.full((7,), float(ls)),
                _port_tp(op)).numpy()
            print(f"retention_time_batch vs JAX retention_time at "
                  f"{_id(op)}, ls={ls}: max rel {max_rel(got, want):.3e}")
