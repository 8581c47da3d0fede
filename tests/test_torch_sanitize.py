"""``repro_torch.analysis.sanitize``, the port's runtime NaN/index sanitizer:
switch precedence, the dispatch-mode wrapping, the kernels' own output
check, and the wired entry points (characterization at nominal and at
corners, scoring, the swept compose, the replay) running clean under
``REPRO_SANITIZE=1`` with results bit-equal to the unsanitized ones.

The counterparts of ``tests/test_sanitize.py``; the JAX package's
``checkify`` sees primitives where the port's mode sees aten ops, so the
checks are the same in kind: a NaN an op makes out of inputs that held
none, and an index outside the extent it indexes.
"""
import numpy as np
import pytest
import torch

from repro_torch import api, hetero
from repro_torch.analysis import sanitize
from repro_torch.core import gainsight
from repro_torch.hetero import system
from repro_torch.sim import engine
from repro_torch.sim.trace import Trace

CPU = "cpu"
# the small space of the reference's test: 10 configs
SMALL = dict(word_sizes=(16,), num_words=(16, 32))


def test_disabled_by_default_returns_fn_unchanged(monkeypatch):
    monkeypatch.delenv("REPRO_SANITIZE", raising=False)

    def f(x):
        return x
    assert sanitize.maybe_wrap(f) is f
    assert not sanitize.enabled()
    assert sanitize.wrap(f).__sanitized__ is True


def test_switch_precedence(monkeypatch):
    monkeypatch.delenv("REPRO_SANITIZE", raising=False)
    assert not sanitize.enabled()
    monkeypatch.setenv("REPRO_SANITIZE", "1")
    assert sanitize.enabled()
    with sanitize.enabled_scope(False):        # scope beats env
        assert not sanitize.enabled()
        with sanitize.enabled_scope(True):     # innermost wins
            assert sanitize.enabled()
            assert not sanitize.enabled(explicit=False)  # explicit beats all
        assert not sanitize.enabled()
    assert sanitize.enabled()


def test_wrap_catches_nan_and_oob_index():
    f = sanitize.wrap(lambda x: torch.log(x))
    with pytest.raises(FloatingPointError, match="nan.*aten.log"):
        f(torch.tensor([-1.0]))
    # an index beyond the extent raises before the op runs, for every kind
    # of indexing op
    x = torch.arange(4.0)
    for fn, args in (
            (lambda x, i: x[i], (x, torch.tensor([9]))),
            (lambda x, i: x[i], (x, torch.tensor([-5]))),
            (lambda x, i: torch.gather(x, 0, i), (x, torch.tensor([1, 4]))),
            (lambda x, i: torch.index_select(x, 0, i),
             (x, torch.tensor([-1]))),
            (lambda x, i: torch.nn.functional.embedding(i, x[:, None]),
             (x, torch.tensor([[0, 4]]))),
            (lambda x, i: x.clone().index_put_((i,), torch.tensor(1.0)),
             (x, torch.tensor([7]))),
            (lambda x, i: torch.zeros(4).scatter_(0, i, x[:1]),
             (x, torch.tensor([5])))):
        with pytest.raises(IndexError, match="out-of-bounds"):
            sanitize.wrap(fn)(*args)
    # a negative index inside the extent is fine where torch allows it
    assert sanitize.wrap(lambda x, i: x[i])(x, torch.tensor([-1])).item() \
        == 3.0


def test_nan_rules_follow_the_inputs():
    """A NaN an op's input already held is not the op's making; garbage in
    an unwritten buffer and a NaN given as a constant are not flagged; an
    in-place op is judged on its inputs before it wrote them."""
    nan_in = torch.tensor([float("nan"), 1.0])
    out = sanitize.wrap(lambda x: torch.exp(x) + 1)(nan_in)
    assert torch.isnan(out[0]) and out[1] == np.e + 1
    assert sanitize.wrap(lambda x: torch.where(x > 0, x, float("nan")))(
        torch.tensor([1.0, -1.0]))[0] == 1.0
    assert sanitize.wrap(lambda x: torch.empty(2).copy_(x) * 2)(
        torch.ones(2)).tolist() == [2.0, 2.0]
    with pytest.raises(FloatingPointError, match="aten.sub"):
        sanitize.wrap(lambda x: x.add_(float("inf")) - float("inf"))(
            torch.ones(2))
    # the first op that made a NaN is named, not a later one that carried it
    with pytest.raises(FloatingPointError, match="aten.sqrt"):
        sanitize.wrap(lambda x: torch.sqrt(x) * 2 + torch.log(x))(
            torch.tensor([-1.0]))


def test_kernel_outputs_are_checked_under_wrap():
    """The CUDA kernels are invisible to the dispatch mode; their wrappers
    call ``check_kernel``, which flags a NaN out of non-NaN inputs and
    names the kernel (and is a no-op outside ``wrap``)."""
    clean, bad = torch.ones(3), torch.tensor([1.0, float("nan")])
    sanitize.check_kernel("retention", (clean,), (bad,))   # no wrap: no-op

    def launch(inputs, outputs):
        sanitize.check_kernel("retention", inputs, outputs)
        return outputs[0]
    with pytest.raises(FloatingPointError, match="kernel retention"):
        sanitize.wrap(launch)((clean,), (bad,))
    assert torch.isnan(sanitize.wrap(launch)((bad,), (bad,))[1])


def test_wrap_preserves_values():
    def f(x):
        return {"y": torch.sqrt(x), "z": x * 2}
    x = torch.tensor([1.0, 4.0])
    plain, wrapped = f(x), sanitize.wrap(f)(x)
    for k in plain:
        np.testing.assert_array_equal(plain[k].numpy(), wrapped[k].numpy())


def test_compiler_sanitize_flag_scopes_characterization(monkeypatch):
    monkeypatch.delenv("REPRO_SANITIZE", raising=False)
    kw = dict(mem_type="gc_sisi", word_size=32, num_words=64)
    clean = api.Compiler(device=CPU).compile(**kw)
    checked = api.Compiler(device=CPU, sanitize=True).compile(**kw)
    assert clean.ppa == checked.ppa     # bit-identical floats
    assert not sanitize.enabled()       # the scope is the call's
    # the flag reaches the wired scoring: a NaN made there raises
    real = system.score_kernel

    def poisoned(idx, cols, cap_bits, f_req):
        out = real(idx, cols, cap_bits, f_req)
        out["p_w"] = torch.log(-out["p_w"])
        return out
    monkeypatch.setattr(system, "score_kernel", poisoned)
    table = api.DesignTable.build(api.design_space(**SMALL), device=CPU)
    api.Compiler(device=CPU).compose(gainsight.TASKS[0], space=table)
    with pytest.raises(FloatingPointError, match="aten.log"):
        api.Compiler(device=CPU, sanitize=True).compose(gainsight.TASKS[0],
                                                        space=table)


def _score_and_replay():
    vals = {"area_um2": 100.0, "bits": 1024.0, "p_leak_w": 1e-6,
            "p_refresh_w": 1e-7, "e_read_j": 1e-12, "f_op_hz": 1e9}
    metrics = {k: np.full(8, v, np.float32) for k, v in vals.items()}
    idx = np.zeros((4, 2), np.int64)
    idx[3, 1] = -1                      # a sentinel slot
    scores = system.score_grid(metrics, idx, [1e6, 1e6], [1e8, 1e8],
                               device=CPU)
    S, T = 2, 8
    trace = Trace(phase="prefill", t_bin_s=np.full(T, 1e-5),
                  reads=np.ones((S, T)), write_bits=np.full((S, T), 64.0),
                  occupancy=np.full((S, T), 0.5),
                  cap_bits=np.full(S, 1e6), f_req_hz=np.full(S, 1e8),
                  lifetime_s=np.full(S, 1e-2))
    sim_vals = {"bits": 4096.0, "word_bits": 32.0, "e_read_j": 1e-12,
                "e_write_j": 2e-12, "f_op_hz": 1e9, "p_leak_w": 1e-6,
                "retention_s": 1e-3}
    cols = {k: np.full(4, v, np.float32) for k, v in sim_vals.items()}
    replays = [engine.simulate_traces(cols, idx[:3], [trace], device=CPU,
                                      oracle=oracle)
               for oracle in (False, True)]
    return scores, replays


def _wired_entry_points():
    """explore, a corner table, a swept compose and api.simulate on the
    small space, plus the scorer and both replay routes."""
    space = api.design_space(**SMALL)
    rep = api.explore(space, device=CPU)
    corner_table = api.DesignTable.build(space, corners=["nominal", "hot"],
                                         device=CPU)
    swept = api.compose(rep.table, gainsight.TASKS[1],
                        compose_policy=hetero.ComposePolicy(
                            vdd_sweep=((1.2, 233.0),)), device=CPU)
    simulated = api.simulate(rep.table, gainsight.TASKS[0], device=CPU)
    return rep, corner_table, swept, simulated, _score_and_replay()


def test_wired_entry_points_run_clean_under_env(monkeypatch):
    """Characterization (nominal and per corner, SRAM rows and the
    start-crossed gain cells included), the scorer (sentinel slots
    included), the swept compose and both replay routes pass the NaN and
    index checks, and give the unsanitized results bit for bit."""
    monkeypatch.delenv("REPRO_SANITIZE", raising=False)
    plain = _wired_entry_points()
    monkeypatch.setenv("REPRO_SANITIZE", "1")
    checked = _wired_entry_points()
    (rep, ctab, swept, sim, (scores, replays)) = checked
    (rep0, ctab0, swept0, sim0, (scores0, replays0)) = plain
    assert len(rep.table) == 10
    assert rep.labels() == rep0.labels()
    for a, b in ((rep.table, rep0.table), (ctab, ctab0)):
        for k in b.metric_names:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    for a, b in ((swept, swept0), (sim, sim0)):
        assert a.labels() == b.labels()
        assert [c.metrics for c in a.ranked] == [c.metrics for c in b.ranked]
    assert np.isfinite(scores["area_um2"][:3]).all()
    for k in system.SYSTEM_METRICS:
        np.testing.assert_array_equal(scores[k], scores0[k], err_msg=k)
    for got, want in zip(replays, replays0):
        assert np.isfinite(got["e_total_j"]).all()
        for m in engine.SIM_METRICS:
            np.testing.assert_array_equal(got[m], want[m], err_msg=m)


def test_sanitized_table_matches_unsanitized_bitexact():
    space = api.design_space(word_sizes=(32,), num_words=(64,))
    base = api.DesignTable.from_configs(space, device=CPU)
    with sanitize.enabled_scope(True):
        checked = api.DesignTable.from_configs(space, device=CPU)
    for k in base.metric_names:
        np.testing.assert_array_equal(base[k], checked[k], err_msg=k)
