"""Requirements from models in the PyTorch port (on the CPU) against the JAX
reference: the shape cells, ``LM.input_specs``, the dry-run records'
counts, the roofline, the traffic profiler's ``TaskReq``s and traces, and
the memory picks ``explore`` and ``memory_dse_annotate`` make from them.

Exact unless a gate is stated. The records are the port's
(``repro_torch.launch.dryrun``, full width on the meta device); both
packages' roofline and profiler read the same JSON. The reference's
``launch/dryrun.py`` sets ``XLA_FLAGS`` when imported, so it is imported
in a fixture after the backend is fixed, and the variable is restored.
"""
import dataclasses
import json
import os
import shutil
import sys
import warnings
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.configs import ALL_ARCHS as J_ARCHS
from repro.configs import SHAPES as J_SHAPES
from repro.configs import applicable_shapes as j_applicable_shapes
from repro.configs import get_config as jax_get_config
from repro.core.select import SelectionPolicy as JSelectionPolicy
from repro.launch import roofline as jroofline
from repro.models import LM as JaxLM
from repro.optim.adamw import AdamWConfig as JAdamWConfig
from repro.optim.adamw import adamw_init as jadamw_init
from repro.profiler import traffic as jtraffic
from repro_torch import api
from repro_torch.configs import ALL_ARCHS, SHAPES, applicable_shapes, get_config
from repro_torch.core.select import SelectionPolicy
from repro_torch.launch import dryrun, roofline
from repro_torch.models import LM
from repro_torch.profiler import traffic

# benchmarks/arch_dse.py's extended space and policy (the paper's Future
# Work adds OS-OS; refreshed gain cells hold hour-lived weights)
ARCH_MEM_TYPES = ("sram6t", "gc_sisi", "gc_ossi", "gc_osos", "gc_osos_hvt")
ARCH_PREFERENCE = ("os-os", "os-si", "si-si", "sram")
ARCH_SHAPES = ("train_4k", "decode_32k")
# tests/test_sim.py's synthetic record: only the fields the profiler reads
SYNTHETIC = {"status": "ok",
             "cost": {"flops_per_device": 1e15, "bytes_per_device": 1e12},
             "collective_bytes_per_device": 1e10}
MESHES = ("pod16x16", "pod2x16x16")
TRACE_ATOL = 1e-12


@pytest.fixture(scope="module")
def jdryrun():
    """The reference's ``launch/dryrun.py``, imported once the backend has
    its one device, with ``XLA_FLAGS`` restored after."""
    jax.devices()
    old = os.environ.get("XLA_FLAGS")
    try:
        import repro.launch.dryrun as mod
    finally:
        if old is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = old
    assert jax.device_count() == 1
    return mod


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    """The port's records of every cell on both meshes, in one directory."""
    out = tmp_path_factory.mktemp("dryrun")
    for extra in ([], ["--multi-pod"]):
        assert dryrun.main(["--all", "--device", "cpu", "--out", str(out)]
                           + extra) == 0
    return out


def _record(records, arch, shape, mesh="pod16x16"):
    return json.loads((records / f"{arch}__{shape}__{mesh}.json").read_text())


@pytest.fixture(scope="module")
def jax_args():
    """arch -> shape -> the JAX step's arguments as the reference's
    ``build_cell`` passes them, as ``jax.eval_shape`` trees (full width,
    nothing allocated), for every applicable cell."""
    out = {}
    for arch in J_ARCHS:
        cfg = jax_get_config(arch)
        lm = JaxLM(cfg)
        params = jax.eval_shape(lm.init, jax.random.key(0))
        out[arch] = {}
        for shape in j_applicable_shapes(cfg):
            batch = lm.input_specs(shape)
            if shape.kind == "train":
                acfg = JAdamWConfig(quantized=cfg.name == "deepseek-v3-671b")
                opt = jax.eval_shape(partial(jadamw_init, acfg=acfg), params)
                args = (params, opt, batch,
                        jax.ShapeDtypeStruct((), jnp.int32))
            elif shape.kind == "prefill":
                args = (params, batch)
            else:
                cache = jax.eval_shape(partial(lm.init_cache,
                                               shape.global_batch,
                                               shape.seq_len))
                args = (params, cache, batch)
            out[arch][shape.name] = args
    return out


def _jax_bytes(tree) -> int:
    return sum(int(np.prod(leaf.shape)) * leaf.dtype.itemsize
               for leaf in jax.tree.leaves(tree))


def _level(lv):
    return (lv.name, lv.capacity_bits,
            tuple((b.frac, b.f_hz, b.lifetime_s) for b in lv.buckets))


def _task(t):
    return (t.task_id, t.name, {k: _level(v) for k, v in t.levels.items()})


# ---------------------------------------------------------------- configs
def test_shape_cells_match_jax():
    assert list(SHAPES) == list(J_SHAPES)
    for name, s in SHAPES.items():
        assert dataclasses.astuple(s) == dataclasses.astuple(J_SHAPES[name])
    assert ALL_ARCHS == J_ARCHS and len(ALL_ARCHS) == 10
    for arch in ALL_ARCHS:
        mine = [s.name for s in applicable_shapes(get_config(arch))]
        assert mine == [s.name for s in
                        j_applicable_shapes(jax_get_config(arch))], arch
    assert {a for a in ALL_ARCHS if len(applicable_shapes(get_config(a)))
            == 4} == {"hymba-1.5b", "xlstm-125m"}


@pytest.mark.parametrize("arch", J_ARCHS)
def test_input_specs_match_jax(arch):
    """Every shape cell's batch: names, shapes and dtypes, on the meta
    device (audio codes and condition, vision tokens and patches, the meta
    tokens trimmed, decode's one token)."""
    lm, jlm = LM(get_config(arch), device="meta"), JaxLM(jax_get_config(arch))
    for name, shape in SHAPES.items():
        got, want = lm.input_specs(shape), jlm.input_specs(J_SHAPES[name])
        assert list(got) == list(want), (arch, name)
        for k, t in got.items():
            assert t.device.type == "meta"
            assert (tuple(t.shape), str(t.dtype).replace("torch.", "")) == \
                (want[k].shape, str(want[k].dtype)), (arch, name, k)


# ---------------------------------------------------------------- records
@pytest.mark.parametrize("arch", J_ARCHS)
def test_record_counts_match_jax(arch, records, jax_args, jdryrun):
    """params_total, params_active and model_flops_global against the
    reference's ``model_flops_params`` on ``jax.eval_shape`` trees, and
    ``argument_bytes`` against the byte sums of the JAX step's arguments;
    the lower bound and the analytic fields as the module says."""
    cfg = jax_get_config(arch)
    for shape_name, args in jax_args[arch].items():
        shape = J_SHAPES[shape_name]
        n_total, n_active = jdryrun.model_flops_params(cfg, args[0])
        tokens = shape.global_batch * (shape.seq_len if shape.kind in
                                       ("train", "prefill") else 1)
        mult = 6 if shape.kind == "train" else 2
        for mesh, chips in zip(MESHES, (256, 512)):
            rec = _record(records, arch, shape_name, mesh)
            assert rec["status"] == "ok"
            assert (rec["params_total"], rec["params_active"],
                    rec["model_flops_global"]) == \
                (n_total, n_active, mult * n_active * tokens)
            assert rec["memory"]["argument_bytes"] == _jax_bytes(args)
            assert rec["memory"]["peak_bytes_per_device"] == \
                _jax_bytes(args) / chips
            ana = jroofline.analytic_cost(arch, shape_name, n_total, n_active)
            assert rec["cost"] == {
                "flops_per_device": ana["flops_global"] / chips,
                "bytes_per_device": ana["hbm_bytes_global"] / chips}
            assert rec["collectives"] == {}
            assert rec["collective_bytes_per_device"] == 0.0
            assert rec["source"] == dryrun.SOURCE
            assert [rec[k] for k in ("arch", "shape", "mesh", "kind",
                                     "seq_len", "global_batch")] == \
                [arch, shape_name, mesh, shape.kind, shape.seq_len,
                 shape.global_batch]


def test_skip_records_match_jax(records, jdryrun, tmp_path):
    """The ``long_500k`` skip record of every full-attention arch is the
    reference's, status and reason included, on both meshes."""
    n = 0
    for arch in J_ARCHS:
        if jax_get_config(arch).supports_long_context:
            continue
        for multi_pod, mesh in zip((False, True), MESHES):
            want = jdryrun.run_cell(arch, "long_500k", multi_pod, tmp_path)
            assert _record(records, arch, "long_500k", mesh) == want
            assert (records / f"{arch}__long_500k__{mesh}.json").read_text() \
                == (tmp_path / f"{arch}__long_500k__{mesh}.json").read_text()
            n += 1
    assert n == 16


# ---------------------------------------------------------------- roofline
@pytest.mark.parametrize("arch", J_ARCHS)
def test_roofline_matches_jax(arch, records):
    """``analytic_cost`` for all four shapes and ``roofline_row`` on every
    record of both meshes, the port's against the reference's, exactly."""
    for shape_name in SHAPES:
        for n in ((1_000_003, 700_001), (7_000_000_000, 1_000_000_000)):
            assert roofline.analytic_cost(arch, shape_name, *n) == \
                jroofline.analytic_cost(arch, shape_name, *n)
        for mesh in MESHES:
            rec = _record(records, arch, shape_name, mesh)
            assert roofline.roofline_row(rec) == jroofline.roofline_row(rec)
            if rec["status"] == "ok":
                assert roofline.analytic_cost(
                    arch, shape_name, rec["params_total"],
                    rec["params_active"]) == jroofline.analytic_cost(
                    arch, shape_name, rec["params_total"],
                    rec["params_active"])


def test_load_table_and_cli_match_jax(records, capsys, monkeypatch):
    for mesh in MESHES:
        got = roofline.load_table(str(records), mesh)
        assert got == jroofline.load_table(str(records), mesh)
        assert len(got) == 32
    roofline.main(["--out", str(records)])
    mine = capsys.readouterr().out
    monkeypatch.setattr(sys, "argv", ["roofline", "--out", str(records)])
    jroofline.main()
    assert mine == capsys.readouterr().out
    assert len(mine.splitlines()) == 33


# ---------------------------------------------------------------- traffic
@pytest.mark.parametrize("arch", J_ARCHS)
def test_traffic_matches_jax(arch, records):
    """``step_time_estimate``, ``arch_requirements`` and ``arch_task``:
    every field, on the port's records and on the synthetic record."""
    for shape_name in SHAPES:
        recs = [dict(SYNTHETIC)]
        rec = _record(records, arch, shape_name)
        if rec["status"] == "ok":
            recs.append(rec)
        for rec in recs:
            assert traffic.step_time_estimate(rec) == \
                jtraffic.step_time_estimate(rec)
            got = traffic.arch_requirements(arch, shape_name, rec)
            want = jtraffic.arch_requirements(arch, shape_name, rec)
            assert got["t_step"] == want["t_step"]
            assert _level(got["L1"]) == _level(want["L1"])
            assert _level(got["L2"]) == _level(want["L2"])
            assert _task(traffic.arch_task(arch, shape_name, rec)) == \
                _task(jtraffic.arch_task(arch, shape_name, rec))
    assert traffic.CORE_CLOCK_HZ == jtraffic.CORE_CLOCK_HZ
    assert (traffic.L1_ANALOG_BITS, traffic.L2_ANALOG_BITS) == \
        (jtraffic.L1_ANALOG_BITS, jtraffic.L2_ANALOG_BITS)
    assert (traffic.PEAK_FLOPS, traffic.HBM_BW, traffic.LINK_BW) == \
        (jtraffic.PEAK_FLOPS, jtraffic.HBM_BW, jtraffic.LINK_BW)


def test_available_arch_tasks_match_jax(records, tmp_path):
    for mesh in MESHES:
        for shapes in (ARCH_SHAPES, tuple(SHAPES)):
            got, missing = traffic.available_arch_tasks(
                shapes, mesh=mesh, outdir=str(records), return_missing=True)
            want, jmissing = jtraffic.available_arch_tasks(
                shapes, mesh=mesh, outdir=str(records), return_missing=True)
            assert [_task(t) for t in got] == [_task(t) for t in want]
            assert missing == jmissing
    assert len(got) == 32 and len(missing) == 8
    assert [_task(t) for t in traffic.available_arch_tasks(
        archs=["qwen3-8b"], outdir=str(records))] == \
        [_task(t) for t in jtraffic.available_arch_tasks(
            archs=["qwen3-8b"], outdir=str(records))]
    # no records: the warning names the directory and the command, and
    # ``return_missing`` says what is missing
    nowhere = str(tmp_path / "nowhere")
    with pytest.warns(RuntimeWarning, match="repro_torch.launch.dryrun --all"):
        tasks, missing = traffic.available_arch_tasks(
            outdir=nowhere, return_missing=True)
    with pytest.warns(RuntimeWarning, match="dry-run"):
        jtasks, jmissing = jtraffic.available_arch_tasks(
            outdir=nowhere, return_missing=True)
    assert tasks == jtasks == [] and missing == jmissing
    assert len(missing) == 20
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        assert traffic.available_arch_tasks(outdir=nowhere) == []
    assert traffic.load_dryrun_record("qwen3-8b", "long_500k",
                                      outdir=str(records)) is None
    with pytest.raises(FileNotFoundError):
        traffic.arch_traces("qwen3-8b", "long_500k", outdir=str(records))


def test_arch_traces_match_jax(records):
    """Every cell's one-phase trace, from the port's records and the
    synthetic one, within 1e-12 of the reference's."""
    n = 0
    for arch in J_ARCHS:
        for shape_name in SHAPES:
            for rec in (dict(SYNTHETIC),
                        traffic.load_dryrun_record(arch, shape_name,
                                                   outdir=str(records))):
                if rec is None:
                    continue
                (got,) = traffic.arch_traces(arch, shape_name, rec=rec,
                                             n_bins=8)
                (want,) = jtraffic.arch_traces(arch, shape_name, rec=rec,
                                               n_bins=8)
                assert got.phase == want.phase
                for f in ("t_bin_s", "reads", "write_bits", "occupancy",
                          "cap_bits", "f_req_hz", "lifetime_s"):
                    a, b = getattr(got, f), getattr(want, f)
                    assert a.shape == b.shape, f
                    np.testing.assert_allclose(a, b, rtol=TRACE_ATOL,
                                               atol=0, err_msg=f)
                n += 1
    assert n == 72
    (got,) = traffic.arch_traces("qwen3-8b", "decode_32k",
                                 outdir=str(records))
    (want,) = jtraffic.arch_traces("qwen3-8b", "decode_32k",
                                   outdir=str(records))
    assert got.n_bins == 32
    np.testing.assert_allclose(got.reads, want.reads, rtol=TRACE_ATOL)


# ---------------------------------------------------------------- picks
def test_explore_labels_over_arch_tasks_match_jax(records, tmp_path):
    """``benchmarks/arch_dse.py``'s ``explore`` over every train_4k and
    decode_32k task: labels equal, on the CPU, with the table cache."""
    tasks = traffic.available_arch_tasks(ARCH_SHAPES, outdir=str(records))
    jtasks = jtraffic.available_arch_tasks(ARCH_SHAPES, outdir=str(records))
    got = api.explore(space=api.design_space(mem_types=ARCH_MEM_TYPES),
                      tasks=tasks,
                      policy=SelectionPolicy(preference=ARCH_PREFERENCE,
                                             allow_refresh=True),
                      cache=tmp_path / "torch", device="cpu")
    want = japi.explore(space=japi.design_space(mem_types=ARCH_MEM_TYPES),
                        tasks=jtasks,
                        policy=JSelectionPolicy(preference=ARCH_PREFERENCE,
                                                allow_refresh=True),
                        cache=tmp_path / "jax")
    assert len(got.labels()) == 20
    assert got.labels() == want.labels()
    assert any("+" in lv["L2"] or lv["L1"] != lv["L2"]
               for lv in got.labels().values())


def test_memory_dse_annotate_and_cli_match_jax(records, jdryrun, tmp_path):
    """``dryrun.main --all --skip-existing --dse`` stamps every ``ok``
    record with the pick the reference's ``memory_dse_annotate`` stamps
    into a copy of the same records: the files are equal."""
    mine, theirs = tmp_path / "torch", tmp_path / "jax"
    for d in (mine, theirs):
        d.mkdir()
        for p in records.glob("*__pod16x16.json"):
            shutil.copy(p, d)
    assert dryrun.main(["--all", "--skip-existing", "--dse", "--device",
                        "cpu", "--out", str(mine)]) == 0
    cells = [(json.loads(p.read_text()), p)
             for p in sorted(theirs.glob("*.json"))]
    jdryrun.memory_dse_annotate(cells, theirs)
    files = sorted(p.name for p in mine.glob("*.json"))
    assert files == sorted(p.name for p in theirs.glob("*.json"))
    stamped = 0
    for name in files:
        assert (mine / name).read_text() == (theirs / name).read_text(), name
        stamped += "memory_dse" in json.loads((mine / name).read_text())
    assert stamped == 32


def test_dryrun_cli(records, tmp_path, monkeypatch):
    """One cell, the multi-pod mesh, a failing cell recorded and the run's
    exit code 1, and the arguments it refuses."""
    assert dryrun.main(["--arch", "qwen3-8b", "--shape", "train_4k",
                        "--device", "cpu", "--out", str(tmp_path)]) == 0
    rec = _record(tmp_path, "qwen3-8b", "train_4k")
    want = _record(records, "qwen3-8b", "train_4k")
    rec.pop("timing"), want.pop("timing")
    assert rec == want
    assert list(tmp_path.glob("*.json")) == \
        [tmp_path / "qwen3-8b__train_4k__pod16x16.json"]

    def broken(*a, **k):
        raise ValueError("no such tree")
    monkeypatch.setattr(dryrun, "step_arguments", broken)
    assert dryrun.main(["--arch", "granite-34b", "--shape", "decode_32k",
                        "--multi-pod", "--device", "cpu",
                        "--out", str(tmp_path)]) == 1
    rec = json.loads((tmp_path / "granite-34b__decode_32k__pod2x16x16.json")
                     .read_text())
    assert rec["status"] == "error" and "no such tree" in rec["error"]
    with pytest.raises(SystemExit):
        dryrun.main(["--device", "cpu", "--out", str(tmp_path)])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            dryrun.main(["--all", "--out", str(tmp_path)])
