"""The port's distribution layer against the JAX package, on the CPU: the
sharding rules (``repro_torch.parallel.sharding``) exactly, for all 10
configs on the 16x16 and 2x16x16 production meshes; ``hint`` and
``maybe_shard``; the sharded train step, the expert-parallel MoE block, the
int8 error-feedback all-reduce and the resharding restore, each run in
gloo worker processes (``repro_torch.launch.spmd.launch``, one launch of 8
ranks and one of 4, each rendezvousing through a ``file://`` store under
``tmp_path`` and bounded by a timeout).

Gates, each ``max|port - ref| <= RTOL * max|ref|`` over a tensor unless
said otherwise (the tolerances of ``tests/test_torch_train.py``):
- the sharded step's loss within ``RTOL_LOSS`` of the JAX 1-device step
  (the reference's own case: ``tests/test_sharding.py``), and two steps
  against the port's single-process ones: the reference case's first (lr
  0 under a warmup of 2) and one at lr 5e-4. Their loss and grad_norm
  within ``RTOL_STEP``, the AdamW moments after them within
  ``RTOL_GRAD[depth]`` (the first moments carry the gradients), and the
  parameters in units of lr (``torch_sharded_checks._update_gaps``):
  within ``RTOL_UPDATE`` lr of one process's wherever the first moment is
  above its reorder noise, which holds the sharded AdamW update on each
  rank's blocks (their alignment with the gradients' and moments',
  weight decay, clipping by the whole norm), and apart by more than lr /
  10 in at most a share ``RTOL_FLIPS`` of all entries. (A leaf that
  starts at zero is all update after the step, so a gap relative to its
  largest entry would read lr's rounding as its size.) The int8-moment
  step stays at the first step;
- the expert-parallel block against the JAX ``shard_map`` block on a 2x4
  mesh of host devices (a subprocess, as ``tests/test_moe_shardmap.py``
  runs it): y within 1e-5 and load within 1e-7 (absolute), the gradients
  of sum(y) within ``RTOL_GRAD[2]``;
- ``ef_int8_psum_mean`` on 4 ranks against JAX on 4 host devices: the int8
  payload identical, the mean and the residuals within 1 ulp;
- checkpoints bit-equal across a 2x2 mesh, a (4,) data mesh and one
  process, both ways, and a checkpoint the JAX package wrote restored onto
  the 2x2 mesh bit-equal.
"""
import contextlib
import functools
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.checkpoint.ckpt import Checkpointer as JaxCheckpointer
from repro.configs import ALL_ARCHS, SHAPES
from repro.configs import get_config as jax_get_config
from repro.configs import reduce_config as jax_reduce_config
from repro.data.pipeline import SyntheticLMData as JaxData
from repro.models import LM as JaxLM
from repro.optim import adamw as jax_adamw
from repro.parallel import sharding as jsh
from repro_torch.configs import get_config
import torch_sharded_checks as checks
from repro_torch.launch import spmd
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import LM
from repro_torch.optim import adamw
from repro_torch.parallel import compression
from repro_torch.parallel import sharding as sh

ROOT = Path(__file__).resolve().parents[1]
RTOL_LOSS = 1e-6
RTOL_GRAD = {2: 3e-4, 4: 2e-3}     # by depth
RTOL_STEP = {"loss": 1e-5, "grad_norm": RTOL_GRAD[4], "lr": 0.0}
# the parameters after a step at lr > 0 (checks._update_gaps): apart by at
# most RTOL_UPDATE lr where the moment is above its noise, and by more than
# lr / 10 in at most a share RTOL_FLIPS of the entries
RTOL_UPDATE, RTOL_FLIPS = 0.1, 1e-3
LAUNCH_TIMEOUT = 240               # seconds a launch may take
# the reference's equivalence case (tests/test_sharding.py)
EQUIV = dict(num_layers=2, d_model=64, num_heads=8, num_kv_heads=8,
             head_dim=8, d_ff=128)
EQUIV_BATCH, EQUIV_SEQ, EQUIV_SEED = 8, 16, 9
HYMBA_BATCH, HYMBA_SEQ, HYMBA_SEED = 4, 24, 3


class _FakeMesh:
    """A mesh as the reference's rules read one (``tests/test_sharding.py``)."""

    def __init__(self, desc):
        self.axis_names = desc.axis_names
        self.shape = desc.shape


MESHES = {"16x16": make_production_mesh(),
          "2x16x16": make_production_mesh(multi_pod=True)}


def _key(k):
    return getattr(k, "key", getattr(k, "idx", getattr(k, "name", None)))


def _jax_specs(tree):
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    return {tuple(_key(k) for k in path): tuple(s) for path, s in flat}


def _port_specs(tree):
    return {path: tuple(s) for path, s in sh.flatten_with_path(tree)}


# ---------------------------------------------------------------------------
# the rules, exactly
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _shapes(arch):
    """Both packages' LM and parameter shapes (abstract / meta) of a
    config."""
    jlm, lm = JaxLM(jax_get_config(arch)), LM(get_config(arch), "meta")
    return jlm, jax.eval_shape(jlm.init, jax.random.key(0)), lm, lm.init()


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_param_batch_and_cache_specs_equal_the_reference(arch, mesh):
    desc = MESHES[mesh]
    fake = _FakeMesh(desc)
    jlm, jparams, lm, params = _shapes(arch)
    for mode in ("train", "infer"):
        assert _port_specs(sh.param_pspec_tree(desc, params, mode)) == \
            _jax_specs(jsh.param_pspec_tree(fake, jparams, mode)), mode
    shape = SHAPES["train_4k"]
    assert _port_specs(sh.batch_pspec_tree(desc, lm.input_specs(shape))) \
        == _jax_specs(jsh.batch_pspec_tree(fake, jlm.input_specs(shape)))
    B, S = SHAPES["decode_32k"].global_batch, SHAPES["decode_32k"].seq_len
    jcache = jax.eval_shape(lambda: jlm.init_cache(B, S))
    assert _port_specs(sh.cache_pspec_tree(desc, lm.init_cache(B, S),
                                           lm.cfg)) == \
        _jax_specs(jsh.cache_pspec_tree(fake, jcache, jlm.cfg))


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("quantized", [False, True], ids=["f32", "int8"])
def test_opt_specs_equal_the_reference(mesh, quantized):
    """deepseek-v3's AdamW state, plain and with int8 moments (the
    ``{"q", "scale"}`` layout)."""
    desc = MESHES[mesh]
    _, jparams, _, params = _shapes("deepseek-v3-671b")
    jopt = jax.eval_shape(lambda p: jax_adamw.adamw_init(
        p, jax_adamw.AdamWConfig(quantized=quantized)), jparams)
    opt = adamw.adamw_init(params, adamw.AdamWConfig(quantized=quantized))
    got = _port_specs(sh.opt_pspec_tree(desc, params, opt))
    assert got == _jax_specs(jsh.opt_pspec_tree(_FakeMesh(desc), jparams,
                                                jopt))
    assert any(path[-1] == "scale" for path in got) == quantized


def test_hint_is_identity_without_mesh():
    x = torch.ones((8, 8))
    assert sh.current_mesh() is None
    assert sh.hint(x, "D", "M") is x
    assert sh.maybe_shard(x, sh.P(None, "model")) is x


def test_maybe_shard_drops_axes_missing_from_mesh():
    """A spec naming an axis the active mesh lacks replicates, never
    raises (``tests/test_sharding.py``), and the value is untouched."""
    data_only = sh.MeshDesc(("data",), (1,))
    assert sh.constraint_spec(data_only, sh.P(("pod", "data"), "model")) \
        == sh.P(("data",), None)
    assert sh.constraint_spec(MESHES["2x16x16"],
                              sh.P(("pod", "data"), "model")) == \
        sh.P(("pod", "data"), "model")
    x = torch.arange(64.0).view(8, 8)
    with sh.use_mesh(data_only):
        assert sh.maybe_shard(x, sh.P(("pod", "data"), "model")) is x
        assert sh.hint(x, "D", "M") is x
        assert sh.hint_spec(data_only, x.shape, "D", "M") == \
            sh.P("data", None)
    assert sh.current_mesh() is None


def test_active_mesh_is_seen_from_other_threads():
    """The autograd engine runs a CUDA backward, and remat's recomputation
    of a layer in it, on threads of its own: they see the active mesh."""
    import threading
    desc, seen = sh.MeshDesc(("data", "model"), (1, 1)), []
    with sh.use_mesh(desc):
        t = threading.Thread(target=lambda: seen.append(sh.current_mesh()))
        t.start()
        t.join(timeout=30)
    assert not t.is_alive() and seen == [desc]
    assert sh.current_mesh() is None


def test_hint_spec_drops_dims_that_do_not_divide():
    desc = MESHES["16x16"]
    assert sh.hint_spec(desc, (32, 25, 64), "D", "M", None) == \
        sh.P("data", None, None)
    assert sh.hint_spec(desc, (32, 48, 64), "D", "M", None) == \
        sh.P("data", "model", None)
    assert sh.hint_spec(MESHES["2x16x16"], (32, 48), "D", "M") == \
        sh.P(("pod", "data"), "model")


# ---------------------------------------------------------------------------
# the JAX side of the multi-process cases
# ---------------------------------------------------------------------------

_JAX_SCRIPT = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
os.environ["REPRO_MOE_SHARDMAP"] = "1"
import sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import PartitionSpec as P
sys.path.insert(0, "src")
from repro.compat import make_mesh, shard_map
from repro.configs import get_config, reduce_config
from repro.models import moe as moe_mod
from repro.parallel.compression import ef_int8_psum_mean

out = sys.argv[1]
cfg = reduce_config(get_config("moonshot-v1-16b-a3b"))
p = moe_mod.init_moe(jax.random.key(0), cfg, jnp.float32)
x = jnp.asarray(np.random.default_rng(0).normal(size=(4, 16, cfg.d_model)),
                jnp.float32)
mesh = make_mesh((2, 4), ("data", "model"))
with mesh:
    y, aux = jax.jit(lambda p, x: moe_mod.moe_block(p, x, cfg))(p, x)
    g = jax.jit(jax.grad(lambda p, x: moe_mod.moe_block(p, x, cfg)[0].sum()))(p, x)
arrays = {"x": np.asarray(x), "y": np.asarray(y),
          "load": np.asarray(aux["load"])}
for k, v in jax.tree_util.tree_flatten_with_path(p)[0]:
    arrays["p|" + "|".join(str(getattr(e, "key", e)) for e in k)] = np.asarray(v)
for k, v in jax.tree_util.tree_flatten_with_path(g)[0]:
    arrays["g|" + "|".join(str(getattr(e, "key", e)) for e in k)] = np.asarray(v)

# ef_int8 on 4 devices: rank r's gradient is g_in[r], two steps
g_in = np.load(sys.argv[2])
dmesh = jax.sharding.Mesh(np.array(jax.devices()[:4]), ("data",))
def f(g, r):
    m, r2 = ef_int8_psum_mean({"w": g[0]}, {"w": r[0]}, "data")
    x = g[0] + r[0]
    scale = jnp.maximum(jax.lax.pmax(jnp.max(jnp.abs(x)), "data"), 1e-12) / 127.0
    q = jnp.clip(jnp.round(x / scale), -127, 127).astype(jnp.int8)
    return m["w"][None], r2["w"][None], q[None]
fm = jax.jit(shard_map(f, mesh=dmesh, in_specs=(P("data"), P("data")),
                       out_specs=(P("data"), P("data"), P("data"))))
resid = jnp.zeros((4, 32, 24), jnp.float32)
for s in range(2):
    mean, resid, q = fm(jnp.asarray(g_in[:, s]), resid)
    arrays[f"ef{s}_mean"] = np.asarray(mean)
    arrays[f"ef{s}_resid"] = np.asarray(resid)
    arrays[f"ef{s}_q"] = np.asarray(q)
np.savez(out, **arrays)
print("ok")
"""


def _ef_grads():
    """Rank r's two gradients for the ef_int8 case: (4, 2, 32, 24)."""
    return np.stack([[np.random.default_rng(100 * r + s).normal(
        size=(32, 24)).astype(np.float32) for s in range(2)]
        for r in range(4)])


def _moe_inputs():
    """The JAX MoE block's weights (key 0) and input, as the subprocess
    draws them (tests/test_moe_shardmap.py)."""
    from repro.models import moe as jax_moe
    cfg = jax_reduce_config(jax_get_config("moonshot-v1-16b-a3b"))
    p = jax.tree.map(np.asarray, jax_moe.init_moe(jax.random.key(0), cfg,
                                                  jnp.float32))
    x = np.random.default_rng(0).normal(size=(4, 16, cfg.d_model))
    return p, np.asarray(x, np.float32)


@pytest.fixture(scope="module")
def jax_multi(tmp_path_factory):
    """The JAX shard_map MoE block and ef_int8 on host devices, in a
    subprocess (the device count is set before jax starts), started first
    and read after the port's launches, which run meanwhile."""
    d = tmp_path_factory.mktemp("jax_multi")
    script, out, g = d / "multi.py", d / "multi.npz", d / "g.npy"
    script.write_text(_JAX_SCRIPT)
    np.save(g, _ef_grads())
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    env.pop("REPRO_MOE_SHARDMAP", None)
    proc = subprocess.Popen([sys.executable, str(script), str(out), str(g)],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, cwd=str(ROOT), env=env)
    result = {}

    def read():
        if not result:
            try:
                _, err = proc.communicate(timeout=LAUNCH_TIMEOUT)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.communicate()
                raise
            assert proc.returncode == 0, err[-2000:]
            result.update(np.load(out))
        return result
    yield read
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


def _jax_step(jcfg, batch_size, seq, seed):
    """The JAX 1-device step's weights (key 0) as numpy, and its loss (the
    reference case's step 0: the loss of its first batch)."""
    lm = JaxLM(jcfg)
    params = jax.jit(lm.init)(jax.random.key(0))
    batch = JaxData(jcfg, batch_size, seq, seed=seed).next_batch()
    loss = float(jax.jit(lambda p, b: lm.loss(p, b)[0])(params, batch))
    return jax.tree.map(np.asarray, params), loss


@pytest.fixture(scope="module")
def equiv_jax():
    jcfg = jax_reduce_config(jax_get_config("internlm2-1.8b")).replace(**EQUIV)
    return _jax_step(jcfg, EQUIV_BATCH, EQUIV_SEQ, EQUIV_SEED)


@pytest.fixture(scope="module")
def hymba_jax():
    return _jax_step(jax_reduce_config(jax_get_config("hymba-1.5b")),
                     HYMBA_BATCH, HYMBA_SEQ, HYMBA_SEED)


# ---------------------------------------------------------------------------
# the port's multi-process runs
# ---------------------------------------------------------------------------


def _train_spec(arch, overrides, mesh, batch, seq, seed, np_params):
    return dict(arch=arch, reduced=True, overrides=overrides, mesh=mesh,
                batch=batch, seq=seq, data_seed=seed, steps=[0, 1],
                base_lr=1e-3, warmup=2, np_params=np_params, trees=True,
                single=True)


@pytest.fixture(scope="module")
def gloo8(equiv_jax, jax_multi, tmp_path_factory):
    """8 gloo ranks: the reference's equivalence case on a 2x4 mesh, and
    the expert-parallel MoE block on 2x4."""
    store = tmp_path_factory.mktemp("gloo8")
    p, x = _moe_inputs()
    moe_spec = dict(arch="moonshot-v1-16b-a3b", reduced=True, mesh=(2, 4),
                    p=p, x=x)
    runs = [(checks.train_check,
               _train_spec("internlm2-1.8b", EQUIV, (2, 4), EQUIV_BATCH,
                           EQUIV_SEQ, EQUIV_SEED, equiv_jax[0])),
              (checks.moe_check, moe_spec)]
    return spmd.launch(spmd.run_all, 8, (runs,), device="cpu",
                       timeout=LAUNCH_TIMEOUT, store_dir=str(store),
                       env={"REPRO_MOE_SHARDMAP": "1"})[0]


def _jax_ckpt(directory, np_params):
    """A checkpoint the JAX package wrote: the reduced hymba's weights (key
    0) with AdamW moments made of them (so that none is zero)."""
    params = jax.tree.map(jnp.asarray, np_params)
    opt = jax_adamw.adamw_init(params)
    opt = {"m": jax.tree.map(lambda p: p * 0.5, params),
           "v": jax.tree.map(lambda p: p * p, params), "count": opt["count"]}
    JaxCheckpointer(directory, async_write=False).save(
        2, params, opt, {"seed": 0, "step": 2})
    return {"params": params, "m": opt["m"], "v": opt["v"]}


@pytest.fixture(scope="module")
def gloo4(hymba_jax, jax_multi, tmp_path_factory):
    """4 gloo ranks: the reduced hymba's step on 2x2, ef_int8 over the 4
    ranks, the reshard round trips and a supervised restart."""
    store = tmp_path_factory.mktemp("gloo4")
    foreign = _jax_ckpt(store / "jax_ckpt", hymba_jax[0])
    ef_g = _ef_grads()
    g = [[{"w": ef_g[r, s]} for s in range(2)] for r in range(4)]
    runs = [(checks.train_check,
               _train_spec("hymba-1.5b", {}, (2, 2), HYMBA_BATCH, HYMBA_SEQ,
                           HYMBA_SEED, hymba_jax[0])),
              (checks.ef_int8_check, {"g": g}),
              (checks.reshard_check,
               dict(arch="hymba-1.5b", reduced=True, mesh=(2, 2),
                    dir=str(store / "ckpt"),
                    foreign=str(store / "jax_ckpt"))),
              (checks.compressed_grad_check, _compressed_spec()),
              (checks.train_check,
               dict(_train_spec("hymba-1.5b", {}, (2, 2), HYMBA_BATCH,
                                HYMBA_SEQ, HYMBA_SEED, hymba_jax[0]),
                    quantized=True, trees=False, steps=[0])),
              (checks.supervised_check,
               dict(arch="hymba-1.5b", reduced=True, mesh=(2, 2),
                    dir=str(store / "sup"), steps=6, fail_at=4, batch=4,
                    seq=24)),
              (checks.hint_check,
               dict(mesh=(2, 2), x=np.arange(48.0).reshape(8, 6)))]
    res = spmd.launch(spmd.run_all, 4, (runs,), device="cpu",
                      timeout=LAUNCH_TIMEOUT, store_dir=str(store))
    return res[0], [r[1] for r in res], foreign, [r[3] for r in res]


def test_hint_and_maybe_shard_place_a_dtensor(gloo4):
    """Under a 2x2 mesh of 4 gloo ranks, ``hint`` and ``maybe_shard``
    redistribute a replicated ``DTensor`` by their specs (axes the mesh
    lacks dropped, tags on a dim that does not divide dropped, a tag list
    of the wrong rank a no-op), the value unchanged; a plain tensor comes
    back as it is."""
    out = gloo4[0][6]
    s0, s1, rep = "Shard(dim=0)", "Shard(dim=1)", "Replicate()"
    want = {"hint_DM_6": [s0, s1], "hint_DM_5": [s0, rep],
            "hint_D__6": [s0, rep], "hint_D__5": [s0, rep],
            "hint_rank_mismatch_6": [rep, rep],
            "maybe_pod_data_model_6": [s0, s1]}
    for label, placements in want.items():
        assert out[label] == (placements, True), (label, out[label])
    assert set(out) == set(want) | {"plain_is_kept"}
    assert out["plain_is_kept"]


def _compressed_spec():
    rng = np.random.default_rng(4)
    return {"w": rng.normal(size=(16, 8)).astype(np.float32),
            "x": rng.normal(size=(8, 16)).astype(np.float32),
            "y": rng.normal(size=(8, 8)).astype(np.float32), "steps": 3}


def _check_step(out, jax_loss, depth):
    (row, last), _ = out["rows"], out["single_rows"]
    assert abs(row["loss"] - jax_loss) <= RTOL_LOSS * abs(jax_loss), \
        (row["loss"], jax_loss)
    gaps = out["gaps"]
    for k in ("loss", "grad_norm", "lr"):
        assert gaps[k] <= RTOL_STEP[k], (k, gaps[k])
    for k in ("m", "v"):
        assert gaps[k] <= RTOL_GRAD[depth], (k, gaps)
    assert gaps["update"] <= RTOL_UPDATE and gaps["flips"] <= RTOL_FLIPS, \
        gaps
    assert row["lr"] == 0.0 and last["lr"] > 0
    assert np.isfinite(row["grad_norm"]) and np.isfinite(last["grad_norm"])


def test_sharded_step_matches_jax_and_one_process_on_2x4(gloo8, equiv_jax):
    """The reference's own case: reduced internlm2-1.8b, 2 layers, d_model
    64, batch 8x16, data seed 9, on a gloo ("data", "model") = (2, 4)
    mesh (heads, d_ff and vocab over "model")."""
    out = gloo8[0]
    assert out["mesh"] == (2, 4) and out["world"] == 8
    _check_step(out, equiv_jax[1], 2)


def test_sharded_hymba_step_matches_jax_and_one_process_on_2x2(gloo4,
                                                               hymba_jax):
    """The reduced hymba (4 layers; the plain attention on each rank's 2 of
    4 heads, the plain scan on its 64 of 128 channels)."""
    out = gloo4[0][0]
    assert out["mesh"] == (2, 2)
    _check_step(out, hymba_jax[1], 4)


def test_sharded_step_with_int8_moments_matches_one_process(gloo4):
    """int8 AdamW moments (the ``{"q", "scale"}`` layout, deepseek-v3's) on
    the 2x2 mesh: each row's scale is the whole row's, its amax taken over
    the ranks that split the row's last dim, so the dequantized moments
    are one process's to within one int8 step of the row."""
    out = gloo4[0][4]
    assert out["mesh"] == (2, 2)
    for k in ("loss", "grad_norm", "lr"):
        assert out["gaps"][k] <= RTOL_STEP[k], (k, out["gaps"])
    assert out["gaps"]["params"] <= RTOL_GRAD[4], out["gaps"]
    for k in ("m", "v"):      # q and scale leaves: an int8 code apart
        assert out["gaps"][k] <= 1.0 / 127.0, (k, out["gaps"])


def test_expert_parallel_moe_matches_jax_shard_map(gloo8, jax_multi):
    """The reduced moonshot's MoE block (8 experts, 2 a rank of "model";
    tokens over "data"), the inputs of tests/test_moe_shardmap.py."""
    out, jax_multi = gloo8[1], jax_multi()
    assert out["mesh"] == (2, 4)
    p, x = _moe_inputs()        # what the port was fed is what JAX ran
    np.testing.assert_array_equal(x, jax_multi["x"])
    for path, v in sh.flatten_with_path(p):
        np.testing.assert_array_equal(v, jax_multi["p|" + "|".join(path)])
    assert np.max(np.abs(out["y"] - jax_multi["y"])) <= 1e-5
    assert np.max(np.abs(out["load"] - jax_multi["load"])) <= 1e-7
    want = {k: v for k, v in jax_multi.items() if k.startswith("g|")}
    got = {"g|" + k: v for k, v in out["grads"].items()}
    assert set(got) == set(want)
    for k in want:
        if k.endswith("|bias"):     # routing only: no gradient in either
            assert not np.any(got[k]) and not np.any(want[k])
            continue
        gap = np.max(np.abs(got[k] - want[k])) / np.max(np.abs(want[k]))
        assert gap <= RTOL_GRAD[2], (k, gap)


def test_ef_int8_matches_jax_on_4_ranks(gloo4, jax_multi):
    per_rank, jax_multi = gloo4[1], jax_multi()
    for s in range(2):
        for r in range(4):
            got = per_rank[r][s]
            np.testing.assert_array_equal(got["q"]["w"],
                                          jax_multi[f"ef{s}_q"][r])
            np.testing.assert_array_max_ulp(got["mean"]["w"],
                                            jax_multi[f"ef{s}_mean"][r], 1)
            np.testing.assert_array_max_ulp(got["resid"]["w"],
                                            jax_multi[f"ef{s}_resid"][r], 1)


def test_compressed_grad_fn_on_a_host_mesh(gloo4):
    """``make_compressed_grad_fn`` on a 4-rank data mesh, 3 steps: the mean
    loss of the batch's four blocks is the whole batch's, and error
    feedback accounts for every bit of each step's compressed mean: it is
    the whole batch's gradient plus the ranks' mean residual carried in,
    less the mean residual carried out (to float32 rounding)."""
    per_rank = gloo4[3]
    out = per_rank[0]
    assert out["mesh"] == (4,)
    carried = np.zeros_like(out["exact_g"])
    for i, st in enumerate(out["steps"]):
        assert abs(st["loss"] - out["exact_loss"]) <= \
            1e-6 * out["exact_loss"], i
        left = np.mean([r["steps"][i]["resid"] for r in per_rank], axis=0)
        np.testing.assert_allclose(st["g"], out["exact_g"] + carried - left,
                                   rtol=0, atol=1e-5, err_msg=str(i))
        assert np.max(np.abs(left)) > 0        # something was carried
        carried = left


def test_checkpoint_reshards_bit_equal(gloo4):
    res = gloo4[0][2]
    for k in ("same_mesh", "data_mesh", "one_device", "to_mesh"):
        assert res[k] is True, k
    assert res["same_mesh_placed"] == (2, 2)
    assert res["data_mesh_placed"] == (4,)
    assert res["to_mesh_placed"] == (2, 2)


def test_jax_checkpoint_restores_sharded(gloo4):
    res, foreign = gloo4[0][2], gloo4[2]
    for part in ("params", "m", "v"):
        want = {"|".join(str(_key(e)) for e in path): np.asarray(v)
                for path, v in jax.tree_util.tree_flatten_with_path(
                    foreign[part])[0]}
        got = res["foreign"][part]
        assert set(got) == set(want), part
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_supervised_restart_is_bit_equal_sharded(gloo4):
    res = gloo4[0][5]
    assert res["restarts"] == 1
    assert res["bit_equal"]
    assert res["losses"][0] == res["losses"][1][-len(res["losses"][0]):]


# ---------------------------------------------------------------------------
# ef_int8 on one rank: the reference's two properties
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def _one_rank(tmp_path):
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_ef_int8_single_rank(tmp_path):
    """On one rank the compressed mean is plain quantization, and error
    feedback carries the residual exactly (tests/test_substrates.py)."""
    rng = np.random.default_rng(0)
    g = {"w": torch.tensor(rng.normal(size=(32, 32)), dtype=torch.float32)}
    with _one_rank(tmp_path):
        mean, resid = compression.ef_int8_psum_mean(
            g, compression.init_residuals(g))
    np.testing.assert_allclose((mean["w"] + resid["w"]).numpy(),
                               g["w"].numpy(), rtol=1e-6, atol=1e-6)
    scale = float(g["w"].abs().max()) / 127.0
    assert float(resid["w"].abs().max()) <= scale * 0.5 + 1e-7


def test_ef_int8_bias_vanishes_over_steps(tmp_path):
    """Accumulated compressed updates converge to the accumulated true
    ones."""
    rng = np.random.default_rng(1)
    seq = [torch.tensor(rng.normal(size=(16,)), dtype=torch.float32)
           for _ in range(50)]
    r = {"w": torch.zeros(16)}
    acc_c, acc_t = torch.zeros(16), torch.zeros(16)
    with _one_rank(tmp_path):
        for g in seq:
            mean, r = compression.ef_int8_psum_mean({"w": g}, r)
            acc_c, acc_t = acc_c + mean["w"], acc_t + g
    np.testing.assert_allclose((acc_c + r["w"]).numpy(), acc_t.numpy(),
                               rtol=1e-5, atol=1e-5)
