"""The collectives that the port's dry-run records count
(``repro_torch.launch.dryrun.count_collectives``: the port's sharded step
run on the meta device over a ``parallel.comm.RecordingMesh``), on the CPU:

- exactly, kind by kind in count and bytes, what a hook on
  ``torch.distributed`` sees in one live sharded train step of the same
  reduced config, batch and mesh, run in gloo worker processes
  (``tests/torch_sharded_checks.collectives_check``) on a (2, 2) and a
  (2, 4) ("data", "model") mesh: a dense config, moonshot with and without
  ``REPRO_MOE_SHARDMAP`` (expert parallel / gathered), hymba and the
  reduced deepseek-v3 (MLA, MoE, MTP, int8 moments);
- within ``XLA_FACTOR`` of XLA's, in total bytes a device, on the reduced
  train cells that the reference's ``launch/dryrun.py`` compiles on an
  8-device XLA:CPU (2, 4) mesh (a subprocess), with all-gather and
  all-reduce in both. XLA issues collective-permutes and all-to-alls of
  its own, which the port's explicit calls do not, so equality with XLA
  is not the gate; the ratios print;
- in every ``ok`` record of the 10 configs on the 16x16 and 2x16x16
  production meshes (``python -m repro_torch.launch.dryrun --all``, two
  subprocesses started together): ``collectives`` not empty, their bytes
  summing to ``collective_bytes_per_device``, and ``SOURCE`` naming both
  fields a count.

    PYTHONPATH=src python -m pytest tests/test_torch_collectives.py
    PYTHONPATH=src python tests/test_torch_collectives.py   # prints the ratios to XLA
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from repro_torch.configs import ShapeConfig, get_config, reduce_config
from repro_torch.launch import spmd
from repro_torch.launch.dryrun import SOURCE, count_collectives
from repro_torch.parallel.sharding import MeshDesc
import torch_sharded_checks as checks

ROOT = Path(__file__).resolve().parents[1]
LAUNCH_TIMEOUT = 240
XLA_FACTOR = 10

# the live steps: (label, arch, environment); every one at BATCH x SEQ
LIVE_RUNS = [("internlm2-1.8b", "internlm2-1.8b", {}),
             ("moonshot-ep", "moonshot-v1-16b-a3b",
              {"REPRO_MOE_SHARDMAP": "1"}),
             ("moonshot-gathered", "moonshot-v1-16b-a3b",
              {"REPRO_MOE_SHARDMAP": "0"}),
             ("hymba-1.5b", "hymba-1.5b", {}),
             ("deepseek-v3-671b", "deepseek-v3-671b", {})]
BATCH, SEQ = 8, 24
MESHES = [(2, 2), (2, 4)]

# the reduced train cells compared with XLA's
XLA_ARCHS = ("internlm2-1.8b", "moonshot-v1-16b-a3b", "deepseek-v3-671b")
XLA_SHAPE = ShapeConfig("train_64", 64, 8, "train")

_XLA_SCRIPT = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import json, sys
import jax
jax.devices()     # 8 host devices, before launch.dryrun asks for 512
sys.path.insert(0, "src")
saved = os.environ["XLA_FLAGS"]
from repro.launch import dryrun
os.environ["XLA_FLAGS"] = saved
from repro.compat import make_mesh
from repro.configs import get_config, reduce_config
from repro.configs.base import ShapeConfig
shape = ShapeConfig("train_64", 64, 8, "train")
mesh = make_mesh((2, 4), ("data", "model"))
out = {}
for arch in sys.argv[1:]:
    cfg = reduce_config(get_config(arch))
    with mesh:
        f, args = dryrun.build_cell(cfg, shape, mesh, 0)
        hlo = f.lower(*args).compile().as_text()
    out[arch] = dryrun.collective_stats(hlo)
print(json.dumps(out))
"""


def _env(extra=None):
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    env["PYTHONPATH"] = "src" + (os.pathsep + env["PYTHONPATH"]
                                 if env.get("PYTHONPATH") else "")
    env.update(extra or {})
    return env


def _output(proc) -> str:
    out, err = proc.communicate(timeout=600)
    assert proc.returncode == 0, err[-3000:]
    return out


@pytest.fixture(scope="module")
def background(tmp_path_factory):
    """Subprocesses started before the live steps and read when a test
    asks: ``launch.dryrun --all`` on both production meshes (the records)
    and the reference's dry run of ``XLA_ARCHS`` (its collective_stats)."""
    out = tmp_path_factory.mktemp("dryrun")
    meshes = ("pod16x16", "pod2x16x16")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--all",
         "--device", "cpu", "--out", str(out / mesh)]
        + (["--multi-pod"] if mesh == "pod2x16x16" else []),
        cwd=str(ROOT), env=_env(), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for mesh in meshes]
    procs.append(subprocess.Popen(
        [sys.executable, "-c", _XLA_SCRIPT, *XLA_ARCHS], cwd=str(ROOT),
        env=_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True))

    def records():
        for proc in procs[:2]:
            _output(proc)
        return {mesh: [json.loads(p.read_text())
                       for p in sorted((out / mesh).glob("*.json"))]
                for mesh in meshes}

    def xla():
        return json.loads(_output(procs[2]).strip().splitlines()[-1])
    yield records, xla
    for proc in procs:          # those a test did not read
        if proc.poll() is None:
            proc.kill()
        proc.communicate()


def _recorded(arch, mesh, env, monkeypatch):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    return count_collectives(reduce_config(get_config(arch)),
                             ShapeConfig("gate", SEQ, BATCH, "train"),
                             MeshDesc(("data", "model"), mesh))


@pytest.fixture(scope="module", params=MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def live(request, background, tmp_path_factory):
    """The live step of every ``LIVE_RUNS`` entry on the mesh, in one
    launch of gloo workers: {label: counts on rank 0}."""
    mesh = request.param
    runs = [(checks.collectives_check,
             dict(arch=arch, reduced=True, mesh=mesh, batch=BATCH, seq=SEQ,
                  data_seed=3, seed=0, env=env,
                  quantized=arch == "deepseek-v3-671b"))
            for _, arch, env in LIVE_RUNS]
    res = spmd.launch(spmd.run_all, mesh[0] * mesh[1], (runs,),
                      device="cpu", timeout=LAUNCH_TIMEOUT,
                      store_dir=str(tmp_path_factory.mktemp("gloo")))[0]
    return mesh, dict(zip((r[0] for r in LIVE_RUNS), res))


@pytest.mark.parametrize("run", LIVE_RUNS, ids=[r[0] for r in LIVE_RUNS])
def test_recorder_equals_a_live_sharded_step(live, run, monkeypatch):
    """The recorder's count of one sharded train step equals, kind by kind
    in count and bytes, what the hook saw the live step call on rank 0."""
    mesh, got = live
    label, arch, env = run
    want = got[label]
    assert want and set(want) >= {"all-gather", "all-reduce"}, want
    assert _recorded(arch, mesh, env, monkeypatch) == want


def xla_ratios(xla):
    """{arch: {kind or "total": port bytes / XLA bytes}} on the (2, 4)
    mesh (None where XLA has none of a kind)."""
    out = {}
    for arch in XLA_ARCHS:
        port = count_collectives(reduce_config(get_config(arch)), XLA_SHAPE,
                                 MeshDesc(("data", "model"), (2, 4)))
        ref = xla[arch]
        kinds = sorted(set(port) | set(ref))
        row = {k: (port.get(k, {"bytes": 0})["bytes"] / ref[k]["bytes"]
                   if ref.get(k, {}).get("bytes") else None) for k in kinds}
        row["total"] = (sum(v["bytes"] for v in port.values())
                        / sum(v["bytes"] for v in ref.values()))
        out[arch] = (row, port, ref)
    return out


def test_recorder_within_10x_of_xla(background, monkeypatch):
    """Each reduced train cell's total bytes a device within
    ``XLA_FACTOR`` of XLA's, all-gather and all-reduce in both."""
    monkeypatch.delenv("REPRO_MOE_SHARDMAP", raising=False)  # --opt 0
    for arch, (row, port, ref) in xla_ratios(background[1]()).items():
        print(arch, {k: None if v is None else round(v, 3)
                     for k, v in row.items()})
        for kind in ("all-gather", "all-reduce"):
            assert port[kind]["count"] > 0 and ref[kind]["count"] > 0, arch
        assert 1 / XLA_FACTOR <= row["total"] <= XLA_FACTOR, (arch, row)


def test_every_record_counts_its_collectives(background):
    """Every ``ok`` record of the 10 configs on both production meshes
    carries counted collectives, summing to its bytes a device."""
    recs = background[0]()
    assert "collectives" in SOURCE["count"]
    assert "collective_bytes_per_device" in SOURCE["count"]
    assert "not_modelled" not in SOURCE
    for mesh, rows in recs.items():
        ok = [r for r in rows if r["status"] == "ok"]
        assert len(ok) == 32 and len(rows) == 40, (mesh, len(ok), len(rows))
        for r in ok:
            c = r["collectives"]
            assert c and all(v["count"] > 0 and v["bytes"] > 0
                             for v in c.values()), r["arch"]
            assert r["collective_bytes_per_device"] == sum(
                v["bytes"] for v in c.values()) > 0
            assert r["source"]["count"] == SOURCE["count"]


if __name__ == "__main__":
    xla = subprocess.Popen([sys.executable, "-c", _XLA_SCRIPT, *XLA_ARCHS],
                           cwd=str(ROOT), env=_env(), stdout=subprocess.PIPE,
                           stderr=subprocess.PIPE, text=True)
    ratios = xla_ratios(json.loads(_output(xla).strip().splitlines()[-1]))
    for arch, (row, port, ref) in ratios.items():
        print(f"{arch}: port {port}\n  XLA {ref}\n  port / XLA bytes "
              f"{ {k: None if v is None else round(v, 3) for k, v in row.items()} }")
