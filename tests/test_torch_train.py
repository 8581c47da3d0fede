"""The training path of the PyTorch port against the JAX package, on the
CPU, at the reduced hymba (``reduce_config``: window 16, 4 meta tokens,
float32) with the JAX weights carried across by ``convert``: ``LM.loss``,
every gradient leaf, the remat policies, ``adamw_update`` (plain and int8
moments) fed the same gradients, and three steps of ``make_train_step``
(plain and with microbatches).

Every float check is ``max|port - jax| <= RTOL * max|jax|`` over a tensor.
Measured against live JAX (``python tests/test_torch_train.py`` prints
them): the loss within 1.6e-7; the gradients within 5.0e-5 at 2 layers (a
global and a sliding-window one) and 3.9e-4 at the 4 layers of the reduced
config, 7.8e-6 at 1 layer; AdamW on the same gradients within 2.3e-7 (an
int8 code one step apart at most); 3 train steps within 1.2e-6 on the
loss, 4.9e-4 on grad_norm, lr equal. The gradients' gap grows 3-8x a layer
as float32 rounding is carried back through the random-weight layers
(JAX's own gradients move by 1.0e-4 at 4 layers when only its attention
blocking changes, 16 vs 8). The RTOLs leave a margin of about 5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduce_config as jax_reduce_config
from repro.data.pipeline import SyntheticLMData as JaxData
from repro.models import LM as JaxLM
from repro.optim import adamw as jax_adamw
from repro.train.step import make_train_step as jax_make_train_step
from repro_torch import convert
from repro_torch.configs import get_config, reduce_config
from repro_torch.models import LM
from repro_torch.optim import adamw
from repro_torch.train.step import init_train_state, make_train_step

RTOL_LOSS = 1e-6
RTOL_GRAD = {2: 3e-4, 4: 2e-3}     # by depth
RTOL_ADAMW = 1e-6                  # the same gradients in both packages
# 3 train steps: the loss (measured 1.2e-6), grad_norm (4.9e-4: the
# gradients' gap at 4 layers) and lr (equal)
RTOL_STEP = {"loss": 1e-5, "grad_norm": RTOL_GRAD[4], "lr": 0.0}
B, SEQ, SEED = 4, 24, 3            # 20 text tokens after 4 meta tokens


def _cfgs(depth):
    jcfg = jax_reduce_config(jax_get_config("hymba-1.5b"))
    cfg = reduce_config(get_config("hymba-1.5b"))
    if depth != cfg.num_layers:
        # a global and a sliding-window layer
        jcfg = jcfg.replace(num_layers=depth, full_attn_every=(0,))
        cfg = cfg.replace(num_layers=depth, full_attn_every=(0,))
    return jcfg, cfg


def _jax_side(depth):
    jcfg, cfg = _cfgs(depth)
    jlm = JaxLM(jcfg)
    jparams = jax.jit(jlm.init)(jax.random.key(0))
    batch = JaxData(jcfg, B, SEQ, seed=SEED).next_batch()
    (loss, _), grads = jax.jit(jax.value_and_grad(
        lambda p, b: jlm.loss(p, b), has_aux=True))(jparams, batch)
    return {"cfg": cfg, "jcfg": jcfg, "jparams": jparams, "batch": batch,
            "loss": float(loss), "grads": grads,
            "np_params": jax.tree.map(np.asarray, jparams)}


@pytest.fixture(scope="module")
def ref4():
    return _jax_side(4)


@pytest.fixture(scope="module")
def ref2():
    return _jax_side(2)


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / np.abs(want).max())


def _port_loss_and_grads(ref, remat="full"):
    cfg = ref["cfg"]
    params = convert.lm_params_from_numpy(cfg, ref["np_params"],
                                          device="cpu")
    flat = adamw.leaves(params)
    for t in flat:
        t.requires_grad_(True)
    loss, metrics = LM(cfg, device="cpu").loss(params, ref["batch"],
                                                remat=remat)
    assert metrics["loss"] is loss
    return loss, torch.autograd.grad(loss, flat)


def loss_gap(ref):
    loss, _ = _port_loss_and_grads(ref)
    return abs(loss.item() - ref["loss"]) / abs(ref["loss"])


def grad_gaps(ref):
    """{leaf path: relative gap} over every gradient leaf."""
    _, grads = _port_loss_and_grads(ref)
    flat = jax.tree_util.tree_flatten_with_path(ref["grads"])[0]
    assert len(flat) == len(grads)
    return {jax.tree_util.keystr(path): _rel(g.numpy(), want)
            for (path, want), g in zip(flat, grads)}


def test_loss_matches_jax(ref4):
    assert loss_gap(ref4) <= RTOL_LOSS


@pytest.mark.parametrize("depth", [2, 4])
def test_every_gradient_leaf_matches_jax(ref2, ref4, depth):
    gaps = grad_gaps({2: ref2, 4: ref4}[depth])
    worst = max(gaps, key=gaps.get)
    assert gaps[worst] <= RTOL_GRAD[depth], (worst, gaps[worst])


def test_remat_policies_give_the_same_gradients(ref2):
    """none, dots (matrix products kept) and full (layer inputs kept) run
    the same arithmetic: the gradients are equal bit for bit."""
    runs = {r: _port_loss_and_grads(ref2, remat=r)
            for r in ("none", "dots", "full")}
    for r in ("dots", "full"):
        assert runs[r][0].item() == runs["none"][0].item()
        for a, b in zip(runs[r][1], runs["none"][1]):
            assert torch.equal(a, b), r


def test_unknown_remat_policy_raises(ref2):
    with pytest.raises(ValueError, match="remat"):
        LM(ref2["cfg"], device="cpu").loss(
            LM(ref2["cfg"], device="cpu").init(torch.Generator()),
            ref2["batch"], remat="some")


# ---------------------------------------------------------------------------
# AdamW: the same gradients into both packages
# ---------------------------------------------------------------------------


def _adamw_runs(ref, acfg_kw, n=3):
    """``n`` AdamW updates in each package from the same parameters, fed the
    same gradients (JAX's, scaled per update); the port's state starts as
    the reference's ``adamw_init``, carried across by ``convert``."""
    jacfg = jax_adamw.AdamWConfig(**acfg_kw)
    acfg = adamw.AdamWConfig(**acfg_kw)
    cfg = ref["cfg"]
    jparams = ref["jparams"]
    jstate = jax_adamw.adamw_init(jparams, jacfg)
    params = convert.lm_params_from_numpy(cfg, ref["np_params"],
                                          device="cpu")
    state = convert.adamw_state_from_numpy(
        cfg, jax.tree.map(np.asarray, jstate), acfg, device="cpu")
    lr_fn = jax_adamw.cosine_schedule(1e-2, 1, 10)
    jupdate = jax.jit(jax_adamw.adamw_update, static_argnums=4)
    gnorms = []
    for i in range(n):
        jgrads = jax.tree.map(lambda g: g * (1.0 + 0.5 * i), ref["grads"])
        lr = lr_fn(i + 1)
        jparams, jstate, jg = jupdate(jgrads, jstate, jparams, lr, jacfg)
        grads = convert.lm_params_from_numpy(
            cfg, jax.tree.map(np.asarray, jgrads), device="cpu")
        params, state, g = adamw.adamw_update(grads, state, params,
                                              float(lr), acfg)
        gnorms.append((g.item(), float(jg)))
    return (jparams, jstate), (params, state), gnorms


def adamw_gaps(ref, quantized):
    (jparams, jstate), (params, state), gnorms = _adamw_runs(
        ref, dict(quantized=quantized))
    gaps = {"grad_norm": max(abs(a - b) / b for a, b in gnorms)}
    mine = convert.lm_params_to_numpy(params)
    for (path, want), got in zip(
            jax.tree_util.tree_flatten_with_path(jparams)[0],
            jax.tree.leaves(mine)):
        gaps[f"params{jax.tree_util.keystr(path)}"] = _rel(got, want)
    mine = convert.adamw_state_to_numpy(state)
    assert int(mine["count"]) == int(jstate["count"])
    for (path, want), got in zip(
            jax.tree_util.tree_flatten_with_path(
                {"m": jstate["m"], "v": jstate["v"]})[0],
            jax.tree.leaves({"m": mine["m"], "v": mine["v"]})):
        key = jax.tree_util.keystr(path)
        if np.asarray(want).dtype == np.int8:
            # an int8 code may round the other way (a 1 in the last place)
            gaps[key] = float(np.abs(got.astype(np.int32) - np.asarray(
                want).astype(np.int32)).max()) / 127.0
        else:
            gaps[key] = _rel(got, want) if np.abs(want).max() > 0 else \
                float(np.abs(got).max())
    return gaps


@pytest.mark.parametrize("quantized", [False, True],
                         ids=["float32", "int8"])
def test_adamw_update_matches_reference_on_the_same_gradients(ref2,
                                                              quantized):
    gaps = adamw_gaps(ref2, quantized)
    worst = max(gaps, key=gaps.get)
    assert gaps[worst] <= (1.0 / 127.0 if quantized else RTOL_ADAMW), \
        (worst, gaps[worst])


def test_weight_decay_follows_the_stacked_shapes(ref2):
    """Every leaf of a segment carries the layer axis, so its norm scales,
    D, b_dt and conv_b decay; only the final norm does not (p.ndim >= 2 on
    the stacked leaves, as in the reference)."""
    params = convert.lm_params_from_numpy(ref2["cfg"], ref2["np_params"],
                                          device="cpu")
    before = {k: v.clone() for k, v in (("ln_f", params["ln_f"]),
                                        ("ln1", params["full0"]["ln1"]))}
    params["ln_f"].fill_(1.0)
    params["full0"]["ln1"].fill_(1.0)
    zeros = adamw.tree_map(torch.zeros_like, params)
    state = adamw.adamw_init(params)
    adamw.adamw_update(zeros, state, params, 0.5)
    assert torch.equal(params["ln_f"], torch.ones_like(before["ln_f"]))
    assert torch.allclose(params["full0"]["ln1"],
                          torch.full_like(before["ln1"], 1.0 - 0.5 * 0.1))


def test_cosine_schedule_matches_reference():
    j = jax_adamw.cosine_schedule(3e-4, 20, 100)
    mine = adamw.cosine_schedule(3e-4, 20, 100)
    for step in (0, 1, 7, 19, 20, 21, 55, 99, 100, 150):
        assert mine(step) == float(j(step)), step


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------


def train_gaps(ref, microbatch, steps=3):
    """Per step (loss, grad_norm, lr) gaps of ``steps`` train steps, lr 1e-3
    with 2 warmup steps, the reference's data stream."""
    kw = dict(base_lr=1e-3, warmup=2, total_steps=10, microbatch=microbatch)
    _, jstep = jax_make_train_step(ref["jcfg"], **kw)
    jstep = jax.jit(jstep)
    _, step = make_train_step(ref["cfg"], device="cpu", **kw)
    jparams = ref["jparams"]
    jopt = jax_adamw.adamw_init(jparams)
    params = convert.lm_params_from_numpy(ref["cfg"], ref["np_params"],
                                          device="cpu")
    opt = adamw.adamw_init(params)
    data = JaxData(ref["jcfg"], B, SEQ, seed=SEED)
    gaps = []
    for i in range(steps):
        batch = data.next_batch()
        jparams, jopt, jm = jstep(jparams, jopt, batch, i)
        params, opt, m = step(params, opt, batch, i)
        gaps.append({k: abs(float(m[k]) - float(jm[k]))
                     / max(abs(float(jm[k])), 1e-30)
                     for k in ("loss", "grad_norm", "lr")})
        assert (float(m["lr"]) == 0.0) == (i == 0)
    return gaps


@pytest.mark.parametrize("microbatch", [None, 2], ids=["plain", "mb2"])
def test_three_train_steps_match_jax(ref4, microbatch):
    gaps = train_gaps(ref4, microbatch)
    for k, tol in RTOL_STEP.items():
        assert max(g[k] for g in gaps) <= tol, (k, gaps)


def test_init_train_state_and_moe_refusal():
    """The state of hymba and, since the MoE family is ported (the refusal
    this test once checked is gone), of a MoE configuration: AdamW moments
    for every leaf, the float32 router and routing bias included (the
    bias's gradient is zero; tests/test_torch_moe.py holds its steps to
    JAX's)."""
    cfg = reduce_config(get_config("hymba-1.5b"))
    params, opt = init_train_state(cfg, torch.Generator().manual_seed(0),
                                   device="cpu")
    assert set(opt) == {"m", "v", "count"} and int(opt["count"]) == 0
    assert all(m.dtype == torch.float32 for m in adamw.leaves(opt["m"]))
    assert [t.shape for t in adamw.leaves(opt["v"])] == \
        [t.shape for t in adamw.leaves(params)]
    moe = reduce_config(get_config("moonshot-v1-16b-a3b"))
    make_train_step(moe, device="cpu")
    params, opt = init_train_state(moe, torch.Generator().manual_seed(0),
                                   device="cpu")
    assert opt["m"]["moe"]["moe"]["bias"].shape == (3, moe.num_experts)
    assert [t.shape for t in adamw.leaves(opt["m"])] == \
        [t.shape for t in adamw.leaves(params)]


def test_adamw_state_carries_across_both_ways(ref2):
    """``convert`` takes the reference's state (int8 moments included) and
    gives it back unchanged."""
    jacfg = jax_adamw.AdamWConfig(quantized=True)
    jstate = jax_adamw.adamw_update(
        ref2["grads"], jax_adamw.adamw_init(ref2["jparams"], jacfg),
        ref2["jparams"], 1e-3, jacfg)[1]
    want = jax.tree.map(np.asarray, jstate)
    state = convert.adamw_state_from_numpy(
        ref2["cfg"], want, adamw.AdamWConfig(quantized=True), device="cpu")
    back = convert.adamw_state_to_numpy(state)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(want)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    with pytest.raises(KeyError):
        convert.adamw_state_from_numpy(ref2["cfg"], want, device="cpu")


if __name__ == "__main__":
    for depth in (2, 4):
        r = _jax_side(depth)
        gaps = grad_gaps(r)
        worst = max(gaps, key=gaps.get)
        print(f"{depth} layers: loss {loss_gap(r):.3e}, worst gradient "
              f"{worst} {gaps[worst]:.3e} (RTOL {RTOL_GRAD[depth]})")
    r = _jax_side(2)
    for q in (False, True):
        gaps = adamw_gaps(r, q)
        worst = max(gaps, key=gaps.get)
        print(f"adamw quantized={q}: worst {worst} {gaps[worst]:.3e}")
    r = _jax_side(4)
    for mb in (None, 2):
        print(f"train steps microbatch={mb}:", train_gaps(r, mb))
    # the gradient norm at initialization grows fast with depth, in both
    # packages alike (the embeddings' 0.02 scale under RMSNorm)
    for depth in (2, 4, 8, 12):
        jcfg = jax_reduce_config(jax_get_config("hymba-1.5b")).replace(
            num_layers=depth, full_attn_every=(0, depth // 2 - 1, depth - 1))
        cfg = reduce_config(get_config("hymba-1.5b")).replace(
            num_layers=depth, full_attn_every=jcfg.full_attn_every)
        jlm = JaxLM(jcfg)
        jparams = jax.jit(jlm.init)(jax.random.key(0))
        batch = JaxData(jcfg, B, SEQ, seed=SEED).next_batch()
        jgrads = jax.jit(jax.grad(lambda p, b: jlm.loss(p, b)[0]))(
            jparams, batch)
        _, grads = _port_loss_and_grads(
            {"cfg": cfg, "batch": batch,
             "np_params": jax.tree.map(np.asarray, jparams)})
        print(f"{depth} layers: grad_norm at init, port "
              f"{float(adamw.global_norm(dict(enumerate(grads)))):.6g}, JAX "
              f"{float(jax_adamw.global_norm(jgrads)):.6g}")
