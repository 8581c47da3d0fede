"""``repro_torch.parallel.grid`` (the device grid) and sharded scoring.

The helpers equal the JAX package's (``pad_to_multiple``,
``_factor_devices``); ``shard_leading`` / ``shard2d`` over a device list
that repeats the CPU (the multi-block path on a one-device host) give the
plain call's results bit for bit, for ``score_grid`` and
``score_grid_corners`` at grid sizes no block count divides; and
``compose(sharded=True)`` equals ``compose()`` exactly and the JAX
package's ``compose(sharded=True)`` within the tables' rtol.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.core import gainsight as jgainsight
from repro.hetero import ComposePolicy as JComposePolicy
from repro.hetero import compose as jcompose
from repro.parallel import grid as jgrid
from repro_torch import api, obs
from repro_torch.core import gainsight
from repro_torch.hetero import ComposePolicy, compose, system
from repro_torch.parallel import grid

CPU = "cpu"
# composition metrics, port vs JAX: the characterized columns' parity
# (float32, <= 5.9e-7 measured; tests/test_torch_explore.py)
RTOL_TABLE = 2e-6


@pytest.mark.parametrize("n", [1, 2, 5, 7, 8, 16, 65])
@pytest.mark.parametrize("multiple", [1, 2, 3, 4, 8])
def test_pad_to_multiple_matches_jax(n, multiple):
    x = np.arange(n * 3, dtype=np.float32).reshape(n, 3)
    got, got_n = grid.pad_to_multiple(torch.from_numpy(x), multiple)
    want, want_n = jgrid.pad_to_multiple(jnp.asarray(x), multiple)
    assert got_n == want_n == n
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_factor_devices_matches_jax():
    for n_dev in range(1, 17):
        for minor_n in range(0, 10):
            assert grid._factor_devices(n_dev, minor_n) == \
                jgrid._factor_devices(n_dev, minor_n), (n_dev, minor_n)


def _random_grid(J, seed):
    """A paper-sized column set (n_configs 120) and a (J, 3) grid with
    sentinel slots."""
    rng = np.random.default_rng(seed)
    cols = {k: rng.uniform(0.5, 2.0, 120).astype(np.float32)
            * np.float32(scale)
            for k, scale in (("area_um2", 1e4), ("bits", 4096.0),
                             ("p_leak_w", 1e-6), ("p_refresh_w", 1e-7),
                             ("e_read_j", 1e-12), ("f_op_hz", 1e9))}
    idx = rng.integers(0, 120, (J, 3)).astype(np.int32)
    idx[rng.random((J, 3)) < 0.05] = -1
    return cols, idx, [2e5, 1e6, 3e7], [1e9, 5e8, 2e8]


@pytest.mark.parametrize("k", [2, 3, 8])
def test_sharded_score_grid_is_bit_equal(k):
    cols, idx, cap_bits, f_req = _random_grid(1001, seed=k)
    plain = system.score_grid(cols, idx, cap_bits, f_req, device=CPU)
    n0 = obs.value("parallel.shard_calls")
    sharded = system.score_grid(cols, idx, cap_bits, f_req, sharded=True,
                                devices=[CPU] * k, device=CPU)
    assert obs.value("parallel.shard_calls") == n0 + 1
    for m in system.SYSTEM_METRICS:
        assert sharded[m].shape == (len(idx),)
        np.testing.assert_array_equal(sharded[m], plain[m], err_msg=m)


@pytest.mark.parametrize("k", [2, 3, 8])
@pytest.mark.parametrize("n_corners", [1, 2, 4])
def test_sharded_score_grid_corners_is_bit_equal(k, n_corners):
    cols, idx, cap_bits, f_req = _random_grid(517, seed=10 * k + n_corners)
    rng = np.random.default_rng(n_corners)
    per_corner = [{c: (v * rng.uniform(0.5, 2.0, v.shape)).astype(
        np.float32) for c, v in cols.items()} for _ in range(n_corners)]
    plain = system.score_grid_corners(per_corner, idx, cap_bits, f_req,
                                      device=CPU)
    n0 = obs.value("parallel.shard_calls")
    sharded = system.score_grid_corners(per_corner, idx, cap_bits, f_req,
                                        sharded=True, devices=[CPU] * k,
                                        device=CPU)
    assert obs.value("parallel.shard_calls") == n0 + 1
    for m in system.SYSTEM_METRICS:
        assert sharded[m].shape == (n_corners, len(idx))
        np.testing.assert_array_equal(sharded[m], plain[m], err_msg=m)


def test_one_device_is_the_plain_call():
    """``devices=None`` on a CPU call is that one device: no split, no
    count, no span."""
    cols, idx, cap_bits, f_req = _random_grid(9, seed=0)
    n0 = obs.value("parallel.shard_calls")
    with obs.enabled_scope(True):
        system.score_grid(cols, idx, cap_bits, f_req, sharded=True,
                          device=CPU)
        names = [e["name"] for e in obs.events()]
    obs.clear()
    assert obs.value("parallel.shard_calls") == n0
    assert "parallel.shard" not in names and "hetero.score" in names


def test_shard_helpers_on_trees_record_their_span():
    x = torch.arange(22.0).reshape(11, 2)
    y = {"w": torch.arange(3.0), "b": torch.ones(3)}

    def f1(a, s):
        return {"sum": a.sum(-1) * s, "pair": (a[:, 0], a[:, 1] + s)}

    def f2(a, c, s):
        return {"o": c["w"][:, None] * a[None, :, 0] + c["b"][:, None] + s}
    s = torch.tensor(2.0)
    with obs.enabled_scope(True):
        got1 = grid.shard_leading(f1, x, s, devices=[CPU] * 4)
        got2 = grid.shard2d(f2, x, y, s, devices=[CPU] * 6)
        spans = [(e["name"], e["args"]["mesh"], e["args"]["n_dev"])
                 for e in obs.events()]
    obs.clear()
    assert spans == [("parallel.shard", "1d", 4), ("parallel.shard", "2d", 6)]
    want1, want2 = f1(x, s), f2(x, y, s)
    assert torch.equal(got1["sum"], want1["sum"])
    assert all(torch.equal(a, b) for a, b in zip(got1["pair"],
                                                 want1["pair"]))
    assert torch.equal(got2["o"], want2["o"])


@pytest.fixture(scope="module")
def tables():
    space = api.design_space()
    return (api.DesignTable.from_configs(space, device=CPU),
            japi.DesignTable.from_configs(japi.design_space()))


@pytest.mark.parametrize("policy", ["default", "power_bb"])
def test_compose_sharded_equals_plain_and_jax(tables, policy):
    table, jtable = tables
    kw = {} if policy == "default" else dict(
        objective="power", candidate_mode="all_feasible",
        search="branch_and_bound")
    task, jtask = gainsight.nlevel_task(3), jgainsight.nlevel_task(3)
    plain = compose(table, task, compose_policy=ComposePolicy(**kw),
                    device=CPU)
    sharded = compose(table, task, compose_policy=ComposePolicy(**kw),
                      sharded=True, device=CPU)
    jsharded = jcompose(jtable, jtask, compose_policy=JComposePolicy(**kw),
                        sharded=True)
    assert sharded.labels() == plain.labels() == jsharded.labels()
    assert [c.metrics for c in sharded.ranked] == \
        [c.metrics for c in plain.ranked]
    for mine, ref in zip(sharded.ranked, jsharded.ranked):
        assert [p.config_idx for lc in mine.levels.values()
                for p in lc.picks] == [p.config_idx
                                       for lc in ref.levels.values()
                                       for p in lc.picks]
        for m, v in ref.metrics.items():
            assert mine.metrics[m] == pytest.approx(v, rel=RTOL_TABLE), m
