"""The training runtime of the PyTorch port against the JAX package's, on
the CPU: the synthetic data stream (bit-equal batches for each (seed,
step)), checkpoints (a float32 checkpoint written by either package
restored by the other bit for bit; bfloat16 leaves as their 16-bit patterns
under the reference's digest), the restarting supervisor (the four tests
of ``tests/test_runtime_smoke.py`` mirrored, and a restart that resumes a
real training run bit for bit), and ``python -m repro_torch.launch.train``.
"""
import os
import subprocess
import sys
import warnings
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.ckpt import Checkpointer as JaxCheckpointer
from repro.configs import get_config as jax_get_config
from repro.configs import reduce_config as jax_reduce_config
from repro.data.pipeline import SyntheticLMData as JaxData
from repro_torch import convert
from repro_torch.checkpoint.ckpt import Checkpointer
from repro_torch.configs import get_config, reduce_config
from repro_torch.data.pipeline import DataState, SyntheticLMData
from repro_torch.optim import adamw
from repro_torch.runtime.supervisor import Supervisor, SupervisorConfig
from repro_torch.train.step import init_train_state, make_train_step

ROOT = Path(__file__).resolve().parents[1]


def _cfgs(reduced=True):
    if reduced:
        return (reduce_config(get_config("hymba-1.5b")),
                jax_reduce_config(jax_get_config("hymba-1.5b")))
    return get_config("hymba-1.5b"), jax_get_config("hymba-1.5b")


# ------------------------------------------------------------ data.pipeline
@pytest.mark.parametrize("reduced,B,S,seed", [(True, 4, 24, 0),
                                              (True, 2, 64, 7),
                                              (False, 4, 1128, 3)],
                         ids=["reduced-4x24", "reduced-2x64", "full-4x1128"])
def test_batches_are_bit_equal_to_the_reference_stream(reduced, B, S, seed):
    cfg, jcfg = _cfgs(reduced)
    mine, theirs = SyntheticLMData(cfg, B, S, seed), JaxData(jcfg, B, S, seed)
    for _ in range(3):
        a, b = mine.next_batch(), theirs.next_batch()
        assert a.keys() == b.keys()
        assert a["tokens"].dtype == b["tokens"].dtype == np.int32
        assert a["tokens"].shape == (B, S - cfg.meta_tokens)
        np.testing.assert_array_equal(a["tokens"], b["tokens"])
    assert mine.state.to_dict() == theirs.state.to_dict()


def test_data_state_roundtrip_resumes_the_exact_stream():
    cfg, _ = _cfgs()
    a = SyntheticLMData(cfg, 2, 16, seed=3)
    a.next_batch()
    saved = a.state.to_dict()
    expected = a.next_batch()
    resumed = SyntheticLMData(cfg, 2, 16, seed=3)
    resumed.state = DataState.from_dict(saved)
    np.testing.assert_array_equal(resumed.next_batch()["tokens"],
                                  expected["tokens"])


# ---------------------------------------------------------------- checkpoint
def _train_state(dtype="float32"):
    """A reduced hymba's parameters and an AdamW state after one update."""
    cfg, _ = _cfgs()
    cfg = cfg.replace(dtype=dtype)
    params, opt = init_train_state(cfg, torch.Generator().manual_seed(1),
                                   device="cpu")
    grads = adamw.tree_map(lambda p: torch.full_like(p, 0.01), params)
    adamw.adamw_update(grads, opt, params, 1e-3)
    return cfg, params, opt


def _equal_trees(a, b):
    la, lb = adamw.leaves(a), adamw.leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y)


def test_checkpoint_roundtrip_is_bit_equal(tmp_path):
    cfg, params, opt = _train_state()
    ck = Checkpointer(tmp_path, keep=2)
    ck.save(5, params, opt, {"seed": 0, "step": 5})
    template = init_train_state(cfg, torch.Generator().manual_seed(9),
                                device="cpu")
    step, p2, o2, dstate = ck.restore(params_template=template[0],
                                      opt_template=template[1])
    assert (step, dstate) == (5, {"seed": 0, "step": 5})
    _equal_trees(p2, params)
    _equal_trees(o2["m"], opt["m"])
    _equal_trees(o2["v"], opt["v"])
    assert int(o2["count"]) == int(opt["count"]) == 1
    for s in (6, 7):
        ck.save(s, params, opt, {"seed": 0, "step": s})
    ck.wait()
    assert sorted(ck.steps()) == [6, 7]            # keep = 2


def test_checkpoint_is_written_from_a_copy(tmp_path):
    """An asynchronous save holds a copy: updating the parameters in place
    right after ``save`` returns does not reach the checkpoint."""
    cfg, params, opt = _train_state()
    before = {k: v.clone() for k, v in (("ln_f", params["ln_f"]),)}
    ck = Checkpointer(tmp_path)
    ck.save(1, params, opt, {"seed": 0, "step": 1})
    params["ln_f"].add_(1.0)
    _, p2, _, _ = ck.restore(params_template=params, opt_template=opt)
    assert torch.equal(p2["ln_f"], before["ln_f"])


def test_float32_checkpoints_cross_between_the_packages(tmp_path):
    """A float32 checkpoint written by the port restores in the reference,
    and one written by the reference restores in the port, bit for bit;
    both write the same digest for the same values."""
    cfg, params, opt = _train_state()
    np_params = convert.lm_params_to_numpy(params)
    np_opt = convert.adamw_state_to_numpy(opt)
    j_params = jax.tree.map(jnp.asarray, np_params)
    j_opt = jax.tree.map(jnp.asarray, np_opt)
    Checkpointer(tmp_path / "port", async_write=False).save(
        3, params, opt, {"seed": 1, "step": 3})
    JaxCheckpointer(tmp_path / "jax", async_write=False).save(
        3, j_params, j_opt, {"seed": 1, "step": 3})
    import json
    digests = [json.loads((tmp_path / w / "step_3" / "manifest.json")
                          .read_text())["params_sha256"]
               for w in ("port", "jax")]
    assert digests[0] == digests[1]
    # port -> reference
    step, jp, jo, dstate = JaxCheckpointer(tmp_path / "port").restore(
        params_template=j_params, opt_template=j_opt)
    assert step == 3 and dstate == {"seed": 1, "step": 3}
    for a, b in zip(jax.tree.leaves((jp, jo)), jax.tree.leaves((np_params,
                                                                np_opt))):
        assert np.asarray(a).dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a), b)
    # reference -> port
    template = init_train_state(cfg, torch.Generator().manual_seed(9),
                                device="cpu")
    step, p2, o2, _ = Checkpointer(tmp_path / "jax").restore(
        params_template=template[0], opt_template=template[1])
    _equal_trees(p2, params)
    _equal_trees(o2["m"], opt["m"])
    _equal_trees(o2["v"], opt["v"])
    assert int(o2["count"]) == int(opt["count"])


def test_bfloat16_leaves_keep_their_bits_and_the_reference_digest(tmp_path):
    cfg, params, opt = _train_state("bfloat16")
    ck = Checkpointer(tmp_path, async_write=False)
    ck.save(2, params, opt, {"seed": 0, "step": 2})
    import json
    manifest = json.loads((tmp_path / "step_2" / "manifest.json")
                          .read_text())
    assert "embed" in manifest["bfloat16"]["params"]
    assert "ln_f" not in manifest["bfloat16"]["params"]      # float32
    assert manifest["bfloat16"]["opt"] == []                  # float32 moments
    _, p2, o2, _ = ck.restore(params_template=params, opt_template=opt)
    _equal_trees(p2, params)
    # the reference's digest over the same values held as jax bfloat16
    import hashlib
    from repro.checkpoint.ckpt import _flatten as jax_flatten
    flat = jax_flatten(jax.tree.map(
        lambda t: jnp.asarray(t.float().numpy()).astype(
            jnp.bfloat16 if t.dtype == torch.bfloat16 else jnp.float32),
        params))
    digest = hashlib.sha256()
    for k in sorted(flat):
        digest.update(flat[k].tobytes())
    assert digest.hexdigest() == manifest["params_sha256"]


def test_restore_without_checkpoints_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        Checkpointer(tmp_path).restore()


# ------------------------------------------------------- runtime.supervisor
class _CountingData:
    """Minimal data source with the pipeline's state contract."""

    def __init__(self):
        self.state = DataState(seed=0, step=0)

    def next_batch(self):
        self.state.step += 1
        return {"x": np.full((2,), float(self.state.step), np.float32)}


def _step_fn(params, opt_state, batch, step):
    loss = torch.tensor(batch["x"]).mean() * 0.0 + 1.0 / (step + 1.0)
    return params, opt_state, {"loss": loss}


def _run(tmp_path, total_steps=4, **sup_kw):
    ckpt = Checkpointer(tmp_path / "ckpt", async_write=False)
    sup = Supervisor(_step_fn, ckpt,
                     cfg=SupervisorConfig(ckpt_every=2, max_restarts=2),
                     **sup_kw)
    params = {"w": torch.zeros((2,), dtype=torch.float32)}
    opt = {"m": torch.zeros((2,), dtype=torch.float32)}
    return sup.run(params, opt, _CountingData(), total_steps=total_steps)


def test_supervisor_clean_run_checkpoints_and_reports(tmp_path):
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        params, opt, report = _run(tmp_path)
    assert report.steps_run == 4 and report.restarts == 0
    assert len(report.losses) == 4 and len(report.heartbeats) == 4
    assert np.all(np.isfinite(report.losses))
    assert Checkpointer(tmp_path / "ckpt").latest_step() == 4


def test_supervisor_restarts_from_latest_checkpoint(tmp_path):
    tripped = []

    def fail_once(step):
        if step == 3 and not tripped:
            tripped.append(step)
            raise RuntimeError("injected fault")

    params, opt, report = _run(tmp_path, failure_injector=fail_once)
    assert tripped == [3]
    assert report.restarts == 1
    assert report.steps_run >= 4            # re-ran the failed step


def test_supervisor_gives_up_after_max_restarts(tmp_path):
    def always_fail(step):
        raise RuntimeError("persistent fault")

    with pytest.raises(RuntimeError, match="persistent fault"):
        _run(tmp_path, failure_injector=always_fail)


def test_supervisor_flags_stragglers(tmp_path):
    def slow_at(step):
        return 0.25 if step == 8 else 0.0

    params, opt, report = _run(tmp_path, total_steps=10,
                               straggler_injector=slow_at)
    assert 8 in report.straggler_events
    assert report.steps_run == 10


def test_supervisor_treats_a_non_finite_loss_as_a_failure(tmp_path):
    def nan_step(params, opt_state, batch, step):
        return params, opt_state, {"loss": torch.tensor(float("nan"))}

    sup = Supervisor(nan_step, Checkpointer(tmp_path, async_write=False),
                     cfg=SupervisorConfig(max_restarts=1))
    with pytest.raises(FloatingPointError, match="non-finite loss"):
        sup.run({"w": torch.zeros(1)}, {}, _CountingData(), total_steps=2)
    assert sup.report.restarts == 2


def supervised_run(tmp_path, fail_at=None, steps=6):
    """``steps`` train steps of the reduced hymba under the supervisor,
    checkpoints every 2, an injected failure at step ``fail_at``. Returns
    (params, report, data state)."""
    cfg, _ = _cfgs()
    _, step = make_train_step(cfg, base_lr=1e-3, warmup=2,
                              total_steps=steps, device="cpu")
    params, opt = init_train_state(cfg, torch.Generator().manual_seed(0),
                                   device="cpu")
    data = SyntheticLMData(cfg, 2, 24, seed=0)
    tripped = []

    def fail(s):
        if s == fail_at and not tripped:
            tripped.append(s)
            raise RuntimeError("injected fault")

    sup = Supervisor(step, Checkpointer(tmp_path, keep=3),
                     SupervisorConfig(ckpt_every=2), failure_injector=fail)
    params, opt, report = sup.run(params, opt, data, total_steps=steps)
    return params, report, data.state.to_dict()


def test_a_restart_resumes_training_bit_for_bit(tmp_path):
    """A failure at step 4 restores step 4's checkpoint and re-seats the
    data stream: the parameters after 6 steps equal an uninjected run's bit
    for bit, and so do the losses of the steps both ran."""
    clean, clean_rep, clean_data = supervised_run(tmp_path / "clean")
    hurt, hurt_rep, hurt_data = supervised_run(tmp_path / "hurt", fail_at=4)
    assert hurt_rep.restarts == 1 and hurt_rep.steps_run == 6
    assert hurt_data == clean_data == {"seed": 0, "step": 6}
    assert hurt_rep.losses == clean_rep.losses
    _equal_trees(hurt, clean)


# ------------------------------------------------------------ launch.train
def test_launch_train_runs_on_the_cpu(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    run = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--reduced",
         "--device", "cpu", "--steps", "2", "--ckpt-dir",
         str(tmp_path / "ck")], capture_output=True, text=True, env=env,
        timeout=300, cwd=tmp_path)
    assert run.returncode == 0, run.stderr
    lines = run.stdout.strip().splitlines()
    assert lines[-2] == ("arch=hymba-1.5b steps=2 restarts=0 "
                         "stragglers=0")
    assert lines[-1].startswith("loss first10=")
    assert (tmp_path / "ck" / "step_2" / "manifest.json").exists()
