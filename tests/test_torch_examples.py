"""The port's smoke script (``scripts/smoke_models_torch.py``) and its four
examples (``examples/torch_*.py``) on the CPU, against the JAX package's
smoke script where they compute the same thing: ``make_batch`` gives the
JAX script's arrays for every arch, and the port's loss on the JAX
weights (carried across by ``convert.lm_params_from_numpy``) is within
RTOL_LOSS of the JAX loss (measured: within 2.5e-7 over the 10 reduced
configs; ``python tests/test_torch_examples.py`` prints them). Each
example's ``main`` runs with ``--device cpu`` writing under ``tmp_path``;
without a card each script's default device raises instead of running on
the CPU.
"""
import importlib.util
import math
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import ALL_ARCHS as JAX_ARCHS
from repro.configs import get_config as jax_get_config
from repro.configs import reduce_config as jax_reduce_config
from repro.models import LM as JaxLM
from repro_torch import convert
from repro_torch.configs import ALL_ARCHS, get_config, reduce_config

ROOT = Path(__file__).resolve().parents[1]
RTOL_LOSS = 1e-5       # |port - jax| / |jax| of the smoke batch's loss


def _load(relpath):
    path = ROOT / relpath
    spec = importlib.util.spec_from_file_location(path.stem, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


smoke = _load("scripts/smoke_models_torch.py")
jax_smoke = _load("scripts/smoke_models.py")
EXAMPLES = {name: _load(f"examples/{name}.py") for name in (
    "torch_quickstart", "torch_heterogeneous_dse", "torch_serve_lm",
    "torch_train_lm")}


def test_the_port_smokes_every_arch_of_the_jax_script():
    assert ALL_ARCHS == JAX_ARCHS


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_make_batch_equals_the_jax_scripts(arch):
    cfg = reduce_config(get_config(arch))
    jcfg = jax_reduce_config(jax_get_config(arch))
    got = smoke.make_batch(cfg, np.random.default_rng(0))
    want = jax_smoke.make_batch(jcfg, np.random.default_rng(0))
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k],
                                                                want[k])


def test_make_batch_draws_arch_after_arch_as_the_jax_script():
    rng, jrng = np.random.default_rng(0), np.random.default_rng(0)
    for arch in ALL_ARCHS:
        got = smoke.make_batch(reduce_config(get_config(arch)), rng)
        want = jax_smoke.make_batch(jax_reduce_config(jax_get_config(arch)),
                                    jrng)
        assert all(np.array_equal(got[k], want[k]) for k in want), arch


def loss_gap(arch):
    """(|port - jax| / |jax| of the loss, the port's ``check``) on the JAX
    script's first batch and the JAX weights."""
    jcfg = jax_reduce_config(jax_get_config(arch))
    jlm = JaxLM(jcfg)
    jparams = jax.jit(jlm.init)(jax.random.key(0))
    batch = jax_smoke.make_batch(jcfg, np.random.default_rng(0))
    want = float(jax.jit(jlm.loss)(jparams, batch)[0])
    cfg = reduce_config(get_config(arch))
    params = convert.lm_params_from_numpy(
        cfg, jax.tree.map(np.asarray, jparams), device="cpu")
    got = smoke.check(cfg, params, smoke.make_batch(
        cfg, np.random.default_rng(0)), "cpu")
    return abs(got["loss"] - want) / abs(want), got


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_port_loss_on_the_jax_weights_matches_jax(arch):
    gap, got = loss_gap(arch)
    assert gap <= RTOL_LOSS
    assert got["finite"] and got["decode_finite"]
    cfg = reduce_config(get_config(arch))
    assert got["logits"] == ((2, cfg.audio_codebooks, cfg.vocab_size)
                             if cfg.audio_codebooks else (2, cfg.vocab_size))


def test_smoke_script_runs_every_arch_on_the_cpu(capsys):
    assert smoke.main(["--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert [line.split()[0] for line in lines] == ALL_ARCHS
    assert all("finite=True decode_finite=True" in line for line in lines)


def test_quickstart_example(tmp_path, capsys):
    out = EXAMPLES["torch_quickstart"].main(["--device", "cpu", "--out",
                                             str(tmp_path)])
    assert out["drc_clean"] and out["lvs_clean"]
    assert 0 < out["n_robust"] < out["n_nominal"]
    assert {p.suffix for p in (tmp_path / "quickstart").iterdir()} >= {
        ".lef", ".lib", ".sp", ".v"}
    assert "cheapest feasible macro" in capsys.readouterr().out


def test_heterogeneous_dse_example_prints_table2_ok(tmp_path, capsys):
    out = EXAMPLES["torch_heterogeneous_dse"].main(
        ["--device", "cpu", "--cache", str(tmp_path)])
    text = capsys.readouterr().out
    assert out["ok"] == 7
    assert sum(line.lstrip().startswith("OK ") for line in
               text.splitlines()) == 7
    assert out["sizing"]["speedup"] > 1


def test_serve_example_is_deterministic_when_greedy(capsys):
    out = EXAMPLES["torch_serve_lm"].main(["--device", "cpu"])
    assert out["deterministic"] is True
    assert out["tokens"].shape == (4, 24)
    # the CPU runs the plain versions: no kernel launch counted
    assert out["launches"] == {"flash_attention": 0, "ssm_scan": 0}
    assert "greedy determinism check: True" in capsys.readouterr().out


def test_train_example_runs_two_steps_without_a_restart(tmp_path):
    report = EXAMPLES["torch_train_lm"].main(
        ["--device", "cpu", "--steps", "2", "--batch", "2", "--seq", "32",
         "--ckpt-dir", str(tmp_path)])
    assert report.steps_run == 2 and report.restarts == 0
    assert all(math.isfinite(x) for x in report.losses)
    assert (tmp_path / "step_2").exists()


@pytest.mark.parametrize("name", ["smoke_models_torch", *EXAMPLES])
def test_default_device_raises_without_a_card(name, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    module = smoke if name == "smoke_models_torch" else EXAMPLES[name]
    argv = {"torch_quickstart": ["--out", str(tmp_path)],
            "torch_heterogeneous_dse": ["--cache", str(tmp_path)],
            "torch_train_lm": ["--steps", "1", "--ckpt-dir",
                               str(tmp_path)]}.get(name, [])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        module.main(argv)


if __name__ == "__main__":      # print the measured loss gaps
    for arch in ALL_ARCHS:
        print(f"{arch}: loss {loss_gap(arch)[0]:.2e}")
