"""The PyTorch port stands alone: it imports neither jax nor the JAX package,
and its entry points run on the CUDA device unless asked for the CPU."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import api, convert
from repro_torch.configs import get_config, reduce_config
from repro_torch.core import characterize as chz
from repro_torch.core import gainsight
from repro_torch.core.devices import DeviceParams
from repro_torch.hetero import compose, score_grid, score_grid_corners
from repro_torch.hetero.system import METRIC_COLS
from repro_torch.kernels import flash_attention as kflash
from repro_torch.kernels import retention as kretention
from repro_torch.kernels import ssm_scan as kssm
from repro_torch.launch import serve as launch_serve
from repro_torch.launch import train as launch_train
from repro_torch.models import LM
from repro_torch.serve.engine import Engine
from repro_torch.sim import simulate_traces, task_traces
from repro_torch.sim.engine import SIM_COLS
from repro_torch.train.step import init_train_state, make_train_step

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) \
    + sorted((ROOT / "tools").glob("*.py")) \
    + [ROOT / "chip_smoke.py"]


def test_import_pulls_in_neither_jax_nor_repro():
    code = (
        "import sys\n"
        "import repro_torch, repro_torch.api, repro_torch.convert\n"
        "import repro_torch.core.characterize, repro_torch.kernels.build\n"
        "import repro_torch.models.lm, repro_torch.serve.engine\n"
        "import repro_torch.launch.serve, repro_torch.kernels.ssm_scan\n"
        "import repro_torch.kernels.flash_attention, repro_torch.configs\n"
        "import repro_torch.hetero, repro_torch.hetero.cache\n"
        "import repro_torch.sim, repro_torch.core.artifacts\n"
        "import repro_torch.core.dse, repro_torch.obs.catalog\n"
        "import repro_torch.obs.__main__, repro_torch.obs.report\n"
        "import repro_torch.analysis.sanitize, repro_torch.parallel.grid\n"
        "import repro_torch.optim.adamw, repro_torch.train.step\n"
        "import repro_torch.data.pipeline, repro_torch.checkpoint.ckpt\n"
        "import repro_torch.runtime.supervisor, repro_torch.launch.train\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith("
        "'jax.') or m == 'repro' or m.startswith('repro.'))\n"
        "print(bad)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120, check=True)
    assert out.stdout.strip() == "[]", out.stdout


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_port_file_imports_jax_or_repro(path):
    names = []
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module)
    bad = [n for n in names
           if n.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, f"{path}: imports {bad}"


ENTRY_POINTS = {
    "characterize_batch": lambda: chz.characterize_batch(
        torch.zeros((1, 7))),
    "characterize_config": lambda: chz.characterize_config(
        api.MacroConfig()),
    "DesignTable.from_configs": lambda: api.DesignTable.from_configs(
        api.design_space()[:2]),
    "DesignTable.build": lambda: api.DesignTable.build(),
    "explore": lambda: api.explore(),
    "explore(corners, robust)": lambda: api.explore(
        corners=["nominal", "hot"], robust="worst_case"),
    "characterize_corners": lambda: chz.characterize_corners(
        torch.zeros((1, 7)), ["hot"]),
    "hetero.compose": lambda: compose(None, gainsight.TASKS[0]),
    "hetero.compose(refine=simulate)": lambda: compose(
        None, gainsight.TASKS[0], refine="simulate"),
    "hetero.compose(sharded)": lambda: compose(
        None, gainsight.TASKS[0], sharded=True),
    "Compiler(telemetry, sanitize).explore": lambda: api.Compiler(
        telemetry=True, sanitize=True).explore(),
    "api.simulate": lambda: api.simulate(task=gainsight.TASKS[0]),
    "sim.simulate_traces": lambda: simulate_traces(
        {k: np.ones(1) for k in SIM_COLS}, np.zeros((1, 2), np.int32),
        task_traces(gainsight.TASKS[0])),
    "Compiler.compile": lambda: api.Compiler().compile(),
    "Compiler.table": lambda: api.Compiler().table(),
    "Compiler.gradient_size": lambda: api.Compiler().gradient_size(
        api.MacroConfig()),
    "gradient_size_macro": lambda: api.gradient_size_macro(
        api.MacroConfig(), steps=1),
    "hetero.score_grid": lambda: score_grid(
        {k: np.ones(2, np.float32) for k in METRIC_COLS},
        np.zeros((1, 2), np.int32), [1.0, 1.0], [1.0, 1.0]),
    "hetero.score_grid_corners": lambda: score_grid_corners(
        [{k: np.ones(2, np.float32) for k in METRIC_COLS}],
        np.zeros((1, 2), np.int32), [1.0, 1.0], [1.0, 1.0]),
    "convert.params_from_numpy": lambda: convert.params_from_numpy(
        DeviceParams, {f: np.zeros(1, np.float32)
                       for f in DeviceParams._fields}),
    "LM": lambda: LM(reduce_config(get_config("hymba-1.5b"))),
    "Engine": lambda: Engine(reduce_config(get_config("hymba-1.5b")), {}),
    "launch.serve": lambda: launch_serve.main(["--reduced"]),
    "convert.lm_params_from_numpy": lambda: convert.lm_params_from_numpy(
        reduce_config(get_config("hymba-1.5b")), {}),
    "convert.adamw_state_from_numpy": lambda: convert.adamw_state_from_numpy(
        reduce_config(get_config("hymba-1.5b")), {}),
    "train.make_train_step": lambda: make_train_step(
        reduce_config(get_config("hymba-1.5b"))),
    "train.init_train_state": lambda: init_train_state(
        reduce_config(get_config("hymba-1.5b"))),
    "launch.train": lambda: launch_train.main(["--reduced", "--steps", "1"]),
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_point_without_device_raises_when_no_cuda(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ENTRY_POINTS[name]()


def test_retention_wrapper_rejects_what_the_kernel_does_not_take():
    ts = torch.logspace(-9, 7, 481)
    good = torch.ones((4, 10))
    with pytest.raises(TypeError):
        kretention.retention_batch(good.double(), ts)
    with pytest.raises(ValueError):
        kretention.retention_batch(torch.ones((4, 9)), ts)
    with pytest.raises(ValueError):
        kretention.retention_batch(torch.ones((10, 4)).t(), ts)
    with pytest.raises(ValueError):
        kretention.retention_batch(good, ts[:1])
    # neither the CPU nor a CUDA device: no plain-version fallback
    with pytest.raises(ValueError, match="cuda or cpu"):
        kretention.retention_batch(good.to("meta"), ts.to("meta"))


def test_cpu_path_does_not_count_kernel_launches():
    before = kretention.retention_batch.launches
    kretention.retention_batch(torch.ones((3, 10)), torch.logspace(-9, 7, 9))
    assert kretention.retention_batch.launches == before


def test_serve_path_calls_the_kernel_wrappers(monkeypatch):
    """Prefill of the reduced hymba: every attention layer, global and
    sliding-window, goes through the flash-attention wrapper with p kept in
    float32, and every layer's SSM heads through the scan wrapper (on the
    CPU they run the plain versions)."""
    from repro_torch.models import attention, ssm
    calls = []

    def spy(name, fn):
        def wrapped(*args, **kwargs):
            calls.append((name, kwargs.get("window"), kwargs.get("round_p")))
            return fn(*args, **kwargs)
        return wrapped
    monkeypatch.setattr(attention, "flash_attention",
                        spy("flash_attention", attention.flash_attention))
    monkeypatch.setattr(ssm, "ssm_scan", spy("ssm_scan", ssm.ssm_scan))
    cfg = reduce_config(get_config("hymba-1.5b"))
    lm = LM(cfg, device="cpu")
    lm.prefill(lm.init(torch.Generator().manual_seed(0)),
               {"tokens": np.zeros((2, 12), np.int32)}, max_seq=24)
    attn = [c for c in calls if c[0] == "flash_attention"]
    assert len(attn) == cfg.num_layers
    assert sum(c[1] is None for c in attn) == len(cfg.full_attn_every)
    assert all(c[1] == cfg.window for c in attn if c[1] is not None)
    assert all(c[2] is False for c in attn)
    assert sum(c[0] == "ssm_scan" for c in calls) == cfg.num_layers


def test_device_tensors_never_reach_the_plain_versions(monkeypatch):
    """Off the CPU each wrapper launches its kernel or raises; it never
    runs its plain version. On the meta device (neither CPU nor CUDA) the
    serve path and every wrapper raise before any plain version runs."""
    def plain(*args, **kwargs):
        raise AssertionError("a plain version ran on a device tensor")
    monkeypatch.setattr(kflash, "attention_ref", plain)
    monkeypatch.setattr(kssm, "ssm_scan_ref", plain)
    monkeypatch.setattr(kretention, "retention_ref", plain)
    cfg = reduce_config(get_config("hymba-1.5b"))
    lm = LM(cfg, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        lm.prefill(lm.init(), {"tokens": np.zeros((2, 12), np.int32)})
    meta = torch.ones((1, 2, 8, 16), device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        kflash.flash_attention(meta, meta, meta)
    x = torch.ones((1, 4, 8), device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        kssm.ssm_scan(x, x, torch.ones((8, 4), device="meta"),
                      torch.ones((1, 4, 4), device="meta"),
                      torch.ones((1, 4, 4), device="meta"),
                      torch.ones((8,), device="meta"))
    with pytest.raises(ValueError, match="cuda or cpu"):
        kretention.retention_batch(torch.ones((4, 10), device="meta"),
                                   torch.ones((9,), device="meta"))
