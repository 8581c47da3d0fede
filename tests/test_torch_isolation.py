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
from repro_torch.core import characterize as chz
from repro_torch.core.devices import DeviceParams
from repro_torch.kernels import retention as kretention

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) \
    + [ROOT / "chip_smoke.py"]


def test_import_pulls_in_neither_jax_nor_repro():
    code = (
        "import sys\n"
        "import repro_torch, repro_torch.api, repro_torch.convert\n"
        "import repro_torch.core.characterize, repro_torch.kernels.build\n"
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
    "convert.params_from_numpy": lambda: convert.params_from_numpy(
        DeviceParams, {f: np.zeros(1, np.float32)
                       for f in DeviceParams._fields}),
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
