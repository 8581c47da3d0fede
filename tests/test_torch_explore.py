"""``explore`` / ``DesignTable`` of the PyTorch port (on the CPU) against the
JAX reference: Table 2, the picks behind it, table queries, and the npz
cache."""
import json

import numpy as np
import pytest

from repro import api as japi
from repro.core import gainsight as jgainsight
from repro_torch import api
from repro_torch.core import gainsight


@pytest.fixture(scope="module")
def reports():
    return api.explore(device="cpu"), japi.explore()


def test_table2_labels_match_jax_and_the_paper(reports):
    got, want = reports
    assert got.labels() == want.labels() == gainsight.TABLE2_EXPECTED
    assert got.matches(gainsight.TABLE2_EXPECTED) == 7
    assert gainsight.TABLE2_EXPECTED == jgainsight.TABLE2_EXPECTED


def test_picks_are_identical_per_task_level_bucket(reports):
    got, want = reports
    assert len(got.table) == len(want.table) == 120
    for tid, levels in want.selections.items():
        for lvl, sel in levels.items():
            mine = got.selections[tid][lvl]
            assert [(p.family, p.config_idx) for p in mine.picks] == \
                [(p.family, p.config_idx) for p in sel.picks], (tid, lvl)


def test_shmoo_and_summary_match(reports):
    got, want = reports
    for t in want.tasks:
        for lvl, req in t.levels.items():
            for b in range(len(req.buckets)):
                np.testing.assert_array_equal(got.shmoo(t.task_id, lvl, b),
                                              want.shmoo(t.task_id, lvl, b))
    assert got.summary() == want.summary()


def test_table_queries_match(reports):
    got, want = reports
    g, w = got.table, want.table
    assert g.axis_names == w.axis_names
    np.testing.assert_array_equal(g.families, w.families)
    assert g.to_configs() == [api.MacroConfig(**vars(c))
                              for c in w.to_configs()]
    gq = g.feasible(1.0e9, 1e-3).pareto("area_um2", "p_leak_w")
    wq = w.feasible(1.0e9, 1e-3).pareto("area_um2", "p_leak_w")
    assert gq.to_configs() == [api.MacroConfig(**vars(c))
                               for c in wq.to_configs()]
    best = gq.best("area_um2")
    assert best.config.mem_type == wq.best("area_um2").config.mem_type
    assert best == gq.macro(int(np.argmin(gq["area_um2"])))
    gc = g.filter(lambda t: t["mem_type"] != "sram6t")
    assert len(gc) == 96


def test_npz_cache_round_trips_and_second_build_is_a_hit(tmp_path,
                                                         monkeypatch):
    space = api.design_space(word_sizes=(16, 32), num_words=(32, 64))
    first = api.DesignTable.build(space, cache=tmp_path, device="cpu")
    files = list(tmp_path.glob("table_*.npz"))
    assert [f.name for f in files] == [f"table_{api.grid_hash(space)}.npz"]

    def no_characterize(*args, **kwargs):
        raise AssertionError("cache hit expected, characterization ran")
    monkeypatch.setattr(api.DesignTable, "from_configs",
                        classmethod(no_characterize))
    second = api.DesignTable.build(space, cache=tmp_path, device="cpu")
    assert second.grid_hash == first.grid_hash
    for k in first.columns:
        np.testing.assert_array_equal(second[k], first[k])


def test_stale_cache_is_rejected_and_rebuilt(tmp_path):
    space = api.design_space(word_sizes=(16,), num_words=(32,))
    api.DesignTable.build(space, cache=tmp_path, device="cpu")
    path = next(tmp_path.glob("table_*.npz"))
    with np.load(path) as z:
        payload = dict(z)
    meta = json.loads(str(payload.pop("__meta__")))
    meta["physics"] = "0" * 16
    np.savez(path, __meta__=json.dumps(meta), **payload)
    with pytest.raises(ValueError, match="stale physics fingerprint"):
        api.DesignTable.load(path)
    with pytest.warns(RuntimeWarning, match="unreadable DesignTable cache"):
        table = api.DesignTable.build(space, cache=tmp_path, device="cpu")
    assert len(table) == len(space)
    api.DesignTable.load(path)          # rewritten with the live fingerprint

    path.write_bytes(b"not an npz")
    with pytest.warns(RuntimeWarning, match="unreadable DesignTable cache"):
        api.DesignTable.build(space, cache=tmp_path, device="cpu")
    api.DesignTable.load(path)


def test_corners_and_robust_are_not_ported_yet():
    """Corners and robust selection are ported (tests/test_torch_corners.py;
    a robust composition refined by replay and a corner table's emitters
    are held in tests/test_torch_sim.py and tests/test_torch_facade.py),
    and so is the rest of their flow, which raised until it was: sharded
    scoring (on the CPU the plain call) and the Compiler's sanitizer and
    telemetry switches leave a corner table's results as they are."""
    space = api.design_space(word_sizes=(16,), num_words=(32,))
    table = api.DesignTable.build(space, corners=["nominal", "hot"],
                                  device="cpu")
    plain = api.compose(table, gainsight.TASKS[0], device="cpu")
    sharded = api.compose(table, gainsight.TASKS[0], sharded=True,
                          device="cpu")
    assert sharded.labels() == plain.labels()
    assert [c.metrics for c in sharded.ranked] == \
        [c.metrics for c in plain.ranked]
    for flag in ("sanitize", "telemetry"):
        on = api.Compiler(device="cpu", **{flag: True}).explore(
            space=table, robust="worst_case")
        assert on.labels() == api.explore(table, robust="worst_case",
                                          device="cpu").labels()
    with pytest.raises(ValueError, match="robust mode"):
        api.explore(table, robust="typical", device="cpu")
