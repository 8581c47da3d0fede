"""``repro_torch.obs``: the tracer / metrics / export / report contracts, the
port's instrumentation of its compiler and serving paths, and parity with
the JAX package's telemetry.

The guarantees proven here:

- **telemetry off is free**: compose results are bit-identical with
  tracing on and off, and warm calls under an enabled scope record no
  kernel build (``new_traces``).
- **the catalog is the surface**: every span/metric name the port emits is
  covered by ``repro_torch.obs.catalog``, and every catalog name is
  documented in ``docs/OBSERVABILITY_TORCH.md``.
- **the same telemetry as the reference**: over one scripted sequence the
  counters both catalogs name move by the same amounts in both packages,
  and the spans come in the same (name, depth) order.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro import api as japi
from repro import obs as jobs
from repro.core import gainsight as jgainsight
from repro.hetero import ComposePolicy as JComposePolicy
from repro.hetero import compose as jcompose
from repro.obs import catalog as jcatalog
from repro_torch import obs
from repro_torch.api import (Compiler, DesignTable, characterize_call_count,
                             design_space)
from repro_torch.configs import get_config, reduce_config
from repro_torch.core import gainsight
from repro_torch.hetero import ComposePolicy, compose, composition_eval_count
from repro_torch.kernels import flash_attention as kflash
from repro_torch.kernels import retention as kretention
from repro_torch.kernels import ssm_scan as kssm
from repro_torch.kernels.build import BUILDS
from repro_torch.models import LM
from repro_torch.obs import catalog, export
from repro_torch.obs import report as obs_report
from repro_torch.serve.engine import Engine
from repro_torch.sim.engine import sim_eval_count

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"
CPU = "cpu"
VDD_SWEEP = ((1.2, 233.0),)


@pytest.fixture(autouse=True)
def _clean_trace():
    """Every test starts with an empty event list and tracing off."""
    for o in (obs, jobs):
        o.disable()
        o.clear()
    yield
    for o in (obs, jobs):
        o.disable()
        o.clear()


@pytest.fixture(scope="module")
def table():
    return DesignTable.from_configs(design_space(), device=CPU)


# ------------------------------------------------------------------ tracer
def test_span_nesting_depth_and_timing():
    with obs.enabled_scope(True):
        with obs.span("t.outer"):
            with obs.span("t.mid"):
                with obs.span("t.inner"):
                    pass
            with obs.span("t.mid2"):
                pass
    ev = {e["name"]: e for e in obs.events()}
    assert set(ev) == {"t.outer", "t.mid", "t.inner", "t.mid2"}
    assert ev["t.outer"]["depth"] == 0
    assert ev["t.mid"]["depth"] == ev["t.mid2"]["depth"] == 1
    assert ev["t.inner"]["depth"] == 2
    # children are contained in the parent's [ts, ts+dur] window
    o = ev["t.outer"]
    for child in ("t.mid", "t.inner", "t.mid2"):
        c = ev[child]
        assert o["ts"] <= c["ts"]
        assert c["ts"] + c["dur"] <= o["ts"] + o["dur"] + 1e-6
    assert all(e["ph"] == "X" and e["dur"] >= 0 for e in obs.events())


def test_span_exception_closes_and_propagates():
    with obs.enabled_scope(True):
        with pytest.raises(ValueError, match="boom"):
            with obs.span("t.fail"):
                raise ValueError("boom")
        with obs.span("t.after"):
            pass
    ev = {e["name"]: e for e in obs.events()}
    assert ev["t.fail"]["args"]["error"] == "ValueError"
    # the failed span restored nesting depth for its successors
    assert ev["t.after"]["depth"] == 0
    assert "error" not in ev["t.after"]["args"]


def test_disabled_span_is_shared_noop_and_emits_nothing():
    assert not obs.enabled()
    s1, s2 = obs.span("t.a"), obs.span("t.b", k=1)
    assert s1 is s2                       # one shared null singleton
    with s1:
        s1.set(ignored=True)
    assert obs.events() == []


def test_span_set_lands_in_args():
    with obs.enabled_scope(True):
        with obs.span("t.s", static=1) as sp:
            sp.set(dynamic=2)
    (e,) = obs.events()
    assert e["args"]["static"] == 1 and e["args"]["dynamic"] == 2


def test_probe_records_kernel_builds_as_new_traces():
    """A build inside a span (the probe counter moving) lands as
    ``new_traces``, the key the JAX package gives a jit cache miss; a span
    whose probe does not move records none."""
    probe = obs.counter("t.builds")
    with obs.enabled_scope(True):
        with obs.span("t.cold", probe=probe):
            probe.inc()
        with obs.span("t.warm", probe=probe):
            pass
    ev = {e["name"]: e for e in obs.events()}
    assert ev["t.cold"]["args"]["new_traces"] == 1
    assert "new_traces" not in ev["t.warm"]["args"]


# ----------------------------------------------------------------- metrics
def test_metrics_registry_shapes():
    c = obs.counter("t.count")
    assert obs.counter("t.count") is c    # get-or-create returns same object
    c.inc()
    c.inc(4)
    obs.gauge("t.level").set(2.5)
    h = obs.histogram("t.lat_s")
    for v in (0.1, 0.3, 0.2):
        h.observe(v)
    snap = obs.snapshot()
    assert snap["counters"]["t.count"] == 5
    assert obs.value("t.count") == 5
    assert snap["gauges"]["t.level"] == 2.5
    hs = snap["histograms"]["t.lat_s"]
    assert hs["count"] == 3 and hs["min"] == 0.1 and hs["max"] == 0.3
    assert hs["mean"] == pytest.approx(0.2)
    obs.REGISTRY.reset()
    snap = obs.snapshot()
    assert snap["counters"]["t.count"] == 0          # names survive a reset
    assert snap["histograms"]["t.lat_s"]["count"] == 0


# ------------------------------------------------------------------ export
@pytest.mark.parametrize("suffix", [".json", ".jsonl"])
def test_export_roundtrip(tmp_path, suffix):
    with obs.enabled_scope(True):
        with obs.span("t.a", k="v"):
            with obs.span("t.b"):
                pass
    n0 = obs.value("t.rt_count")
    obs.counter("t.rt_count").inc(3)
    path = tmp_path / f"trace{suffix}"
    export.write(path, obs.events(), obs.snapshot())
    events, metrics = export.read(path)
    assert len(events) == len(obs.events())
    for got, want in zip(events, obs.events()):
        assert set(got) == set(want)
        for k in ("name", "cat", "ph", "tid", "depth", "args"):
            assert got[k] == want[k]
        for k in ("ts", "dur"):                # writer rounds to 1 ns
            assert got[k] == pytest.approx(want[k], abs=1e-3)
    assert metrics["counters"]["t.rt_count"] == n0 + 3


def test_chrome_trace_is_perfetto_shaped(tmp_path):
    with obs.enabled_scope(True):
        with obs.span("t.x"):
            pass
    obs.counter("t.ctr").inc()
    path = tmp_path / "trace.json"
    export.write_chrome(path, obs.events(), obs.snapshot())
    doc = json.loads(path.read_text())
    assert doc["otherData"]["schema"] == export.SCHEMA_VERSION
    phases = {e["ph"] for e in doc["traceEvents"]}
    assert phases == {"X", "C"}
    x = next(e for e in doc["traceEvents"] if e["ph"] == "X")
    assert {"name", "cat", "ts", "dur", "pid", "tid"} <= set(x)
    c = next(e for e in doc["traceEvents"]
             if e["ph"] == "C" and e["name"] == "t.ctr")
    assert c["args"]["value"] == obs.value("t.ctr")


def test_report_render(tmp_path):
    with obs.enabled_scope(True):
        with obs.span("t.render_me"):
            pass
    obs.counter("t.render_count").inc(7)
    text = obs_report.render(obs.events(), obs.snapshot())
    assert "t.render_me" in text and "t.render_count" in text
    path = tmp_path / "trace.json"
    obs.write(path)
    assert "t.render_me" in obs_report.render_file(path)


def test_report_cli_module(tmp_path):
    with obs.enabled_scope(True):
        with obs.span("t.cli"):
            pass
    path = tmp_path / "trace.json"
    obs.write(path)
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.obs", "report", str(path)],
        capture_output=True, text=True, timeout=120,
        env={**os.environ, "PYTHONPATH": str(SRC)})
    assert out.returncode == 0, out.stderr
    assert "t.cli" in out.stdout


def test_env_var_enables_and_atexit_flushes(tmp_path):
    """``REPRO_TRACE`` in a process that imports only the port: the JAX
    package reads the same variable, so a process importing both would
    register two writers to one path."""
    path = tmp_path / "envtrace.json"
    code = ("import sys\n"
            "import repro_torch.obs as obs\n"
            "assert obs.enabled()\n"
            "with obs.span('t.env'):\n"
            "    pass\n"
            "assert not any(m == 'repro' or m.startswith('repro.') "
            "for m in sys.modules)\n")
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        timeout=120, env={**os.environ, "PYTHONPATH": str(SRC),
                          "REPRO_TRACE": str(path)})
    assert out.returncode == 0, out.stderr
    events, _ = export.read(path)
    assert [e["name"] for e in events] == ["t.env"]


# ----------------------------------------------- counter-backed public API
def test_counter_migration_backs_public_counts(table):
    t = gainsight.TASKS[0]
    c0, s0 = composition_eval_count(), sim_eval_count()
    compose(table, t, refine="simulate", device=CPU)
    assert composition_eval_count() > c0       # scoring sweep counted
    assert sim_eval_count() == s0 + 1          # one replay sweep
    assert obs.value("hetero.compose_evals") == composition_eval_count()
    assert obs.value("sim.replay_calls") == sim_eval_count()
    k0 = characterize_call_count()
    DesignTable.from_configs(design_space()[:2], device=CPU)
    assert characterize_call_count() == k0 + 1
    assert obs.value("api.characterize_calls") == characterize_call_count()


# --------------------------------------------------- off-is-free contracts
def test_bit_identical_with_telemetry_on(table):
    t = gainsight.TASKS[1]
    ref = compose(table, t, refine="simulate", device=CPU)
    with obs.enabled_scope(True):
        traced = compose(table, t, refine="simulate", device=CPU)
    assert obs.events()                        # tracing actually happened
    assert traced.labels() == ref.labels()
    for a, b in zip(ref.ranked, traced.ranked):
        assert set(a.metrics) == set(b.metrics)
        for k in a.metrics:
            assert a.metrics[k] == b.metrics[k], k   # bit-exact, no tol


def test_no_new_builds_under_enabled_scope(table):
    """Warm calls under tracing record no kernel build (the CPU builds
    none; on the card the libraries are built on first use)."""
    t = gainsight.TASKS[2]
    # the spans' probe is the registry's counter that kernels.build bumps
    assert obs.counter("kernels.builds") is BUILDS
    compose(table, t, device=CPU)
    n0 = BUILDS.value
    with obs.enabled_scope(True):
        compose(table, t, device=CPU)
        DesignTable.from_configs(design_space()[:2], device=CPU)
    assert BUILDS.value == n0
    probed = [e for e in obs.events()
              if e["name"] in ("hetero.score", "api.characterize")]
    assert {e["name"] for e in probed} == {"hetero.score", "api.characterize"}
    assert all("new_traces" not in e["args"] for e in probed)


# ------------------------------------------------- end-to-end acceptance
def test_trace_of_compose_simulate_run(table, tmp_path):
    """One compose(refine="simulate") under tracing yields a Perfetto-shaped
    trace holding characterize/score/search/replay spans plus cache-hit and
    branch-and-bound pruning counters."""
    t = gainsight.TASKS[0]
    hit0 = obs.value("hetero.cache_hits")
    miss0 = obs.value("hetero.cache_misses")
    nodes0 = obs.value("hetero.search_nodes")
    pruned0 = obs.value("hetero.search_pruned")
    cp = ComposePolicy(search="branch_and_bound")
    with obs.enabled_scope(True):
        small = DesignTable.from_configs(design_space(), device=CPU)
        compose(small, t, compose_policy=cp, cache=tmp_path,
                refine="simulate", device=CPU)
        compose(small, t, compose_policy=cp, cache=tmp_path,
                refine="simulate", device=CPU)   # second call: cache hit
        path = tmp_path / "trace.json"
        obs.write(path)

    names = {e["name"] for e in obs.events()}
    assert {"api.characterize", "hetero.compose", "hetero.search",
            "hetero.score", "sim.replay", "sim.replay_phase",
            "sim.rerank"} <= names
    assert obs.value("hetero.cache_misses") == miss0 + 1
    assert obs.value("hetero.cache_hits") == hit0 + 1
    assert obs.value("hetero.search_nodes") > nodes0       # B&B ran
    assert obs.value("hetero.search_pruned") >= pruned0
    hits = [e for e in obs.events()
            if e["name"] == "hetero.compose" and
            e["args"].get("cache") == "hit"]
    assert len(hits) == 1

    doc = json.loads(path.read_text())         # Perfetto-loadable shape
    ctrs = doc["otherData"]["metrics"]["counters"]
    assert "hetero.cache_hits" in ctrs and "hetero.search_pruned" in ctrs
    assert {e["name"] for e in doc["traceEvents"] if e["ph"] == "C"} >= {
        "hetero.cache_hits", "hetero.search_pruned"}


def test_compiler_telemetry_flag(table):
    t = gainsight.TASKS[0]
    Compiler(device=CPU).compose(t, space=table)
    assert obs.events() == []                  # default: off
    Compiler(device=CPU, telemetry=True).compose(t, space=table)
    assert {e["name"] for e in obs.events()} >= {"hetero.compose",
                                                 "hetero.search"}
    assert not obs.enabled()                   # scope-local, not sticky
    obs.clear()
    Compiler(device=CPU, telemetry=True).compile(mem_type="gc_sisi",
                                                 word_size=16, num_words=16)
    assert [e["name"] for e in obs.events()] == ["api.compile"]
    assert not obs.enabled()


def test_serve_engine_prefill_decode_spans():
    cfg = reduce_config(get_config("hymba-1.5b"))
    lm = LM(cfg, device=CPU)
    eng = Engine(cfg, lm.init(torch.Generator().manual_seed(0)), max_seq=32,
                 device=CPU)
    p0 = obs.value("serve.prefill_calls")
    d0 = obs.value("serve.decode_steps")
    h0 = obs.snapshot()["histograms"].get(
        "serve.decode_step_s", {"count": 0})["count"]
    s0 = obs.snapshot()["histograms"].get(
        "serve.sample_s", {"count": 0})["count"]
    with obs.enabled_scope(True):
        eng.generate({"tokens": np.zeros((2, 4), np.int32)}, steps=3)
    names = [e["name"] for e in obs.events()]
    assert names.count("serve.prefill") == 1
    assert names.count("serve.decode_step") == 3
    assert obs.value("serve.prefill_calls") == p0 + 1
    assert obs.value("serve.decode_steps") == d0 + 3
    hs = obs.snapshot()["histograms"]["serve.decode_step_s"]
    assert hs["count"] == h0 + 3 and hs["min"] > 0
    # the CPU builds no kernel, so no span paid one
    prefill = next(e for e in obs.events() if e["name"] == "serve.prefill")
    assert "new_traces" not in prefill["args"]
    assert prefill["args"]["batch"] == 2
    # sampling has its own span + histogram: decode_step time does not
    # absorb the sampling or the host copy of the token
    assert names.count("serve.sample") == 3
    ss = obs.snapshot()["histograms"]["serve.sample_s"]
    assert ss["count"] == s0 + 3 and ss["min"] > 0
    by_start = sorted((e for e in obs.events()
                       if e["name"] in ("serve.decode_step", "serve.sample")),
                      key=lambda e: e["ts"])
    # the loop samples from the previous logits, then decodes: strict
    # (sample, decode) alternation with disjoint spans — the host copy
    # between them is charged to neither
    for samp, dec in zip(by_start[::2], by_start[1::2]):
        assert (samp["name"], dec["name"]) == ("serve.sample",
                                               "serve.decode_step")
        assert dec["ts"] >= samp["ts"] + samp["dur"]


@pytest.mark.parametrize("op", ["retention", "flash_attention", "ssm_scan"])
def test_kernels_dispatch_counter(op):
    """On the CPU each wrapper counts its plain version, never its kernel."""
    plain, cuda = (f"kernels.dispatch.{op}.plain",
                   f"kernels.dispatch.{op}.cuda")
    n0, c0 = obs.value(plain), obs.value(cuda)
    rng = np.random.default_rng(0)

    def f32(*shape):
        return torch.from_numpy(rng.uniform(0.1, 1.0, shape).astype(
            np.float32))
    if op == "retention":
        kretention.retention_batch(torch.ones((3, 10)),
                                   torch.logspace(-9, 7, 9))
    elif op == "flash_attention":
        kflash.flash_attention(f32(1, 2, 8, 16), f32(1, 2, 8, 16),
                               f32(1, 2, 8, 16))
    else:
        kssm.ssm_scan(f32(1, 4, 8), f32(1, 4, 8), -f32(8, 4), f32(1, 4, 4),
                      f32(1, 4, 4), f32(8))
    assert obs.value(plain) == n0 + 1
    assert obs.value(cuda) == c0
    assert catalog.covers(plain) and catalog.covers(cuda)


def test_catalog_covers_every_emitted_name(table, tmp_path):
    with obs.enabled_scope(True):
        compose(table, gainsight.TASKS[0], refine="simulate", device=CPU)
        compose(table, gainsight.TASKS[1],
                compose_policy=ComposePolicy(vdd_sweep=VDD_SWEEP),
                device=CPU)
        DesignTable.build(design_space()[:2], cache=tmp_path, device=CPU)
        Compiler(device=CPU).compile(mem_type="gc_sisi", word_size=16,
                                     num_words=16)
    for e in obs.events():
        assert catalog.covers(e["name"]), e["name"]
    snap = obs.snapshot()
    for section in ("counters", "gauges", "histograms"):
        for name in snap[section]:
            if name.startswith("t."):          # fixtures from this file
                continue
            assert catalog.covers(name), name


def test_every_catalog_name_is_documented():
    doc = (ROOT / "docs" / "OBSERVABILITY_TORCH.md").read_text()
    for name in (*catalog.SPANS, *catalog.METRICS):
        assert f"`{name}`" in doc, name


# ---------------------------------------------------- parity with JAX
def _jax_run(tmp):
    table = japi.DesignTable.from_configs(japi.design_space())
    cp = JComposePolicy(search="branch_and_bound")
    for _ in range(2):
        jcompose(table, jgainsight.TASKS[0], compose_policy=cp, cache=tmp,
                 refine="simulate")
    jcompose(table, jgainsight.TASKS[1],
             compose_policy=JComposePolicy(vdd_sweep=VDD_SWEEP))


def _port_run(tmp):
    table = DesignTable.from_configs(design_space(), device=CPU)
    cp = ComposePolicy(search="branch_and_bound")
    for _ in range(2):
        compose(table, gainsight.TASKS[0], compose_policy=cp, cache=tmp,
                refine="simulate", device=CPU)
    compose(table, gainsight.TASKS[1],
            compose_policy=ComposePolicy(vdd_sweep=VDD_SWEEP), device=CPU)


def _counter_deltas(o, run, tmp):
    before = dict(o.snapshot()["counters"])
    with o.enabled_scope(True):
        run(tmp)
    after = o.snapshot()["counters"]
    return {k: v - before.get(k, 0) for k, v in after.items()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The scripted sequence in both packages, traced: (counter deltas,
    [(span name, depth)]) for each."""
    out = {}
    for key, o, run in (("jax", jobs, _jax_run), ("port", obs, _port_run)):
        o.clear()
        deltas = _counter_deltas(o, run, tmp_path_factory.mktemp(key))
        out[key] = (deltas, [(e["name"], e["depth"]) for e in o.events()])
        o.clear()
    return out


def test_shared_counters_move_as_in_jax(runs):
    """Every counter both catalogs name (exact entries, not patterns)
    moves by the same amount in both packages over the same sequence."""
    shared = sorted(k for k in set(catalog.METRICS) & set(jcatalog.METRICS)
                    if "<" not in k and catalog.METRICS[k][0] == "counter")
    (jd, _), (pd, _) = runs["jax"], runs["port"]
    got = {k: pd.get(k, 0) for k in shared}
    want = {k: jd.get(k, 0) for k in shared}
    assert got == want
    # the sequence moved the counters it exercises
    for k in ("api.characterize_calls", "hetero.cache_hits",
              "hetero.cache_misses", "hetero.search_nodes",
              "hetero.search_batches", "hetero.expanded_points",
              "sim.cache_hits", "sim.cache_misses", "sim.replay_calls"):
        assert got[k] > 0, k


def test_spans_come_in_the_jax_order(runs):
    """The same sequence under tracing gives the same (span name, depth)
    list in both packages (events in the order they close)."""
    (_, jspans), (_, pspans) = runs["jax"], runs["port"]
    assert pspans == jspans
    assert {n for n, _ in pspans} >= {
        "api.characterize", "hetero.compose", "hetero.search",
        "hetero.score", "hetero.expand", "sim.rerank", "sim.replay",
        "sim.replay_phase"}
