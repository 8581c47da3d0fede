"""The MoE family (moonshot-v1-16b-a3b; deepseek-v3-671b with MLA and MTP)
and the rest of the dense family (qwen3-8b: qk-norm; granite-34b: MQA and
the GELU MLP) of the PyTorch port against the JAX package, on the CPU, at
the reduced configurations (``reduce_config``: 4 layers, d_model 64, 8
experts top-2, float32; the MoE ones dropless at capacity_factor 16) with
the JAX weights carried across by ``convert.lm_params_from_numpy``.

Every float check is ``max|port - jax| <= RTOL * max|jax|`` over a tensor.
Measured against live JAX (``python tests/test_torch_moe.py`` prints
them): prefill logits within 8.8e-6 and cache leaves (the MLA latent cache
included) within 4.8e-6, teacher-forced decode logits within 2.4e-5 and
the caches after decode within 1.2e-5 (granite, whose one kv head and
GELU carry the most rounding), so RTOL = 1e-4 as for hymba
(tests/test_torch_serve.py); ``moe_block`` alone in an overflowing case
(capacity_factor 1, a skewed router: 48 of 64 entries dropped) within
1.2e-7, its kept set, slots, load and dropped share exactly equal; the
loss within 6.1e-8, every gradient leaf within 2.2e-5 (RTOL_GRAD 1e-4);
three train steps within 6.2e-8 on the loss, 2.3e-6 on grad_norm and
8.0e-8 on moe_balance, moe_dropped 3.0e-8 apart (absolute), the routing
bias equal. The load is the reference's bit for bit (it scales the counts
by the float32 reciprocal of N k, as XLA does), so the bias update's signs
agree. Greedy tokens must be identical. The top-k choices must agree: the
inputs hold no tie at the k-th score (checked where the test reads the
choices).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduce_config as jax_reduce_config
from repro.data.pipeline import SyntheticLMData as JaxData
from repro.models import LM as JaxLM
from repro.models import moe as jax_moe
from repro.optim import adamw as jax_adamw
from repro.serve.engine import Engine as JaxEngine
from repro.train.step import make_train_step as jax_make_train_step
from repro.train.step import update_moe_bias as jax_update_moe_bias
from repro_torch import convert
from repro_torch.configs import get_config, reduce_config
from repro_torch.models import LM
from repro_torch.models import moe
from repro_torch.optim import adamw
from repro_torch.serve.engine import Engine
from repro_torch.train.step import make_train_step, update_moe_bias

RTOL = 1e-4              # logits and every cache leaf
RTOL_MOE = 1e-6          # moe_block alone: y
RTOL_LOSS = 1e-6
RTOL_GRAD = 1e-4
RTOL_STEP = {"loss": 1e-5, "grad_norm": RTOL_GRAD, "lr": 0.0,
             "moe_balance": 1e-6}
# moe_dropped, a share in [0, 1], compared absolutely: JAX's mean of the
# keep flags rounds to a few 1e-8 off 0 where the port's is exactly 0
ATOL_DROPPED = 1e-6
ARCHS = ["moonshot-v1-16b-a3b", "deepseek-v3-671b", "qwen3-8b",
         "granite-34b"]
B, SEQ, SEED = 4, 24, 3            # the training batch


def _cfgs(arch):
    return (jax_reduce_config(jax_get_config(arch)),
            reduce_config(get_config(arch)))


def _models(arch):
    jcfg, cfg = _cfgs(arch)
    jlm = JaxLM(jcfg)
    jparams = jax.jit(jlm.init)(jax.random.key(0))
    params = convert.lm_params_from_numpy(
        cfg, jax.tree.map(np.asarray, jparams), device="cpu")
    return jcfg, jlm, jparams, cfg, LM(cfg, device="cpu"), params


@pytest.fixture(scope="module", params=ARCHS)
def models(request):
    return _models(request.param)


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}/{k}")
    elif isinstance(tree, (tuple, list)):
        for i, t in enumerate(tree):
            yield from _leaves(t, f"{path}[{i}]")
    else:
        yield path, tree


def _rel(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = np.abs(want).max()
    if scale == 0:          # a zero gradient (the routing bias) stays zero
        return float(np.abs(got).max())
    return float(np.abs(got - want).max() / scale)


def _cache_gaps(cache, jcache):
    mine, theirs = dict(_leaves(cache)), dict(_leaves(jcache))
    assert sorted(mine) == sorted(theirs)
    assert mine["/pos"] == int(theirs["/pos"])
    return {p: _rel(mine[p].numpy(), w) for p, w in theirs.items()
            if p != "/pos"}


def _tokens(cfg, b, s, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)


def _prefill_gaps(m, S0=12, max_seq=24):
    jcfg, jlm, jparams, cfg, lm, params = m
    toks = _tokens(cfg, 2, S0, S0)
    jcache, jlogits = jax.jit(lambda p, b: jlm.prefill(p, b, max_seq=max_seq))(
        jparams, {"tokens": toks})
    with torch.inference_mode():
        cache, logits = lm.prefill(params, {"tokens": toks}, max_seq=max_seq)
    return _rel(logits.numpy(), jlogits), _cache_gaps(cache, jcache)


def test_prefill_logits_and_every_cache_leaf_match_jax(models):
    logit_gap, cache_gaps = _prefill_gaps(models)
    assert logit_gap <= RTOL
    assert max(cache_gaps.values()) <= RTOL, cache_gaps


def _decode_gaps(m, S0=12, N=8):
    jcfg, jlm, jparams, cfg, lm, params = m
    toks = _tokens(cfg, 2, S0 + N, 7)
    max_seq = S0 + N + 4
    jcache, _ = jax.jit(lambda p, b: jlm.prefill(p, b, max_seq=max_seq))(
        jparams, {"tokens": toks[:, :S0]})
    jdecode = jax.jit(jlm.decode)
    worst = 0.0
    with torch.inference_mode():
        cache, _ = lm.prefill(params, {"tokens": toks[:, :S0]},
                              max_seq=max_seq)
        for t in range(S0, S0 + N):
            jlogits, jcache = jdecode(jparams, jcache, {"tokens": toks[:, t]})
            logits, cache = lm.decode(params, cache, {"tokens": toks[:, t]})
            worst = max(worst, _rel(logits.numpy(), jlogits))
    return worst, _cache_gaps(cache, jcache)


def test_teacher_forced_decode_matches_jax(models):
    logit_gap, cache_gaps = _decode_gaps(models)
    assert logit_gap <= RTOL
    assert max(cache_gaps.values()) <= RTOL, cache_gaps


def test_engine_greedy_tokens_match_jax(models):
    jcfg, jlm, jparams, cfg, lm, params = models
    batch = {"tokens": _tokens(cfg, 3, 10, 0)}
    want = JaxEngine(jcfg, jparams, max_seq=32).generate(batch, steps=12)
    engine = Engine(cfg, params, max_seq=32, device="cpu")
    got = engine.generate(batch, steps=12)
    assert got.dtype == np.int32 and got.shape == (3, 12)
    assert np.array_equal(got, want)
    assert np.array_equal(engine.generate(batch, steps=12), got)


def test_decode_matches_prefill(models):
    """The port's own decode-vs-prefill consistency (the reference's
    tests/test_models.py gate); the reduced MoE configs drop nothing."""
    cfg, lm, params = models[3:]
    toks = _tokens(cfg, 2, 20, 1)
    with torch.inference_mode():
        cache, logits = lm.prefill(params, {"tokens": toks[:, :14]},
                                   max_seq=24)
        for t in range(14, 20):
            logits, cache = lm.decode(params, cache, {"tokens": toks[:, t]})
        _, full = lm.prefill(params, {"tokens": toks}, max_seq=24)
    np.testing.assert_allclose(logits.numpy(), full.numpy(), rtol=2e-2,
                               atol=2e-2)


def test_init_cache_has_the_reference_layout(models):
    jcfg, jlm, jparams, cfg, lm, params = models
    want = dict(_leaves(jlm.init_cache(3, 20)))
    got = dict(_leaves(lm.init_cache(3, 20)))
    assert sorted(got) == sorted(want)
    assert got["/pos"] == int(want["/pos"])
    for path, w in want.items():
        if path != "/pos":
            g = got[path]
            assert str(g.dtype).replace("torch.", "") == str(w.dtype), path
            assert np.array_equal(g.numpy(), np.asarray(w)), path


# ---------------------------------------------------------------------------
# moe_block alone, overflowing
# ---------------------------------------------------------------------------


def _jax_slots(ids, E, C):
    """The reference's sort-based slot assignment (``_moe_block_gspmd``)
    on its expert ids: (order, keep, slot_e, slot_c) in sorted order."""
    flat = ids.reshape(-1)
    order = jnp.argsort(flat)
    s_ids = flat[order]
    start = jnp.searchsorted(s_ids, jnp.arange(E), side="left")
    rank = jnp.arange(flat.shape[0]) - start[s_ids]
    keep = rank < C
    return tuple(np.asarray(a) for a in (
        order, keep, jnp.where(keep, s_ids, 0), jnp.where(keep, rank, 0)))


def _overflow_case(seed=0, Bsz=2, S=16):
    """A reduced moonshot MoE layer at capacity_factor 1 (C = 8) whose
    router sends most of the 32 tokens to experts 0, 1 and 2."""
    jcfg, cfg = _cfgs("moonshot-v1-16b-a3b")
    jcfg, cfg = (c.replace(capacity_factor=1.0) for c in (jcfg, cfg))
    jp = jax_moe.init_moe(jax.random.key(seed), jcfg, jnp.float32)
    jp["router"] = jp["router"].at[:, :3].add(jnp.asarray([0.05, 0.04, 0.02]))
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(Bsz, S, jcfg.d_model)) + 1.0).astype(np.float32)
    p = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), jp)
    return jcfg, cfg, jp, p, x


def moe_gaps(seed=0):
    jcfg, cfg, jp, p, x = _overflow_case(seed)
    N = x.shape[0] * x.shape[1]
    jids, _, _ = jax_moe._route(jp, jnp.asarray(x.reshape(N, -1)), jcfg)
    ids, w, probs = moe._route(p, torch.from_numpy(x.reshape(N, -1)), cfg)
    # no tie at the k-th choice: the top-k sets are the reference's
    sel = np.sort((probs + p["bias"]).numpy(), axis=-1)[:, ::-1]
    assert (sel[:, cfg.top_k - 1] > sel[:, cfg.top_k]).all()
    assert np.array_equal(ids.numpy(), np.asarray(jids))
    C = moe.capacity(N, cfg)
    order, s_ids, rank, keep = moe.dispatch(ids, cfg.num_experts, C)
    j_order, j_keep, j_e, j_c = _jax_slots(jids, jcfg.num_experts, C)
    assert np.array_equal(order.numpy(), j_order)
    assert np.array_equal(keep.numpy(), j_keep)
    assert np.array_equal(torch.where(keep, s_ids, 0).numpy(), j_e)
    assert np.array_equal(torch.where(keep, rank, 0).numpy(), j_c)
    jy, jaux = jax_moe.moe_block(jp, jnp.asarray(x), jcfg)
    y, aux = moe.moe_block(p, torch.from_numpy(x), cfg)
    return {"y": _rel(y.numpy(), jy), "dropped": float(aux["dropped"]),
            "jax_dropped": float(jaux["dropped"]),
            "load_equal": np.array_equal(aux["load"].numpy(),
                                         np.asarray(jaux["load"])),
            "entropy": _rel(aux["router_entropy"].numpy(),
                            jaux["router_entropy"]),
            "n_dropped": int((~keep).sum())}


def test_moe_block_overflow_keeps_the_reference_slots():
    """capacity_factor 1 and a skewed router: the same entries kept, in the
    same slots (the kept set, the expert and rank of each), the same
    dropped share and load; y within RTOL_MOE (a dropped entry adds
    nothing to the token in slot (0, 0))."""
    g = moe_gaps()
    assert g["n_dropped"] > 20
    assert g["dropped"] == g["jax_dropped"] and g["load_equal"]
    assert g["y"] <= RTOL_MOE and g["entropy"] <= RTOL_MOE, g


def test_gelu_mlp_matches_jax():
    from repro.models.mlp import init_mlp as jax_init_mlp
    from repro.models.mlp import mlp_block as jax_mlp_block
    from repro_torch.models.mlp import mlp_block
    jp = jax_init_mlp(jax.random.key(1), 64, 96, "gelu", jnp.float32)
    x = np.random.default_rng(1).normal(size=(2, 5, 64)).astype(np.float32)
    want = jax_mlp_block(jp, jnp.asarray(x))
    got = mlp_block({k: torch.from_numpy(np.array(v)) for k, v in jp.items()},
                    torch.from_numpy(x))
    assert set(jp) == {"wi", "wd"}
    assert _rel(got.numpy(), want) <= 1e-6


# ---------------------------------------------------------------------------
# training: the loss and its metrics, gradients, the bias update, steps
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def train_ref():
    return _train_ref()


def _train_ref(arch="deepseek-v3-671b"):
    jcfg, cfg = _cfgs(arch)
    jlm = JaxLM(jcfg)
    jparams = jax.jit(jlm.init)(jax.random.key(0))
    batch = JaxData(jcfg, B, SEQ, seed=SEED).next_batch()
    (loss, metrics), grads = jax.jit(jax.value_and_grad(
        lambda p, b: jlm.loss(p, b), has_aux=True))(jparams, batch)
    return {"cfg": cfg, "jcfg": jcfg, "jparams": jparams, "batch": batch,
            "loss": float(loss), "metrics": metrics, "grads": grads,
            "np_params": jax.tree.map(np.asarray, jparams)}


def _port_loss_and_grads(ref):
    params = convert.lm_params_from_numpy(ref["cfg"], ref["np_params"],
                                          device="cpu")
    flat = adamw.leaves(params)
    for t in flat:
        t.requires_grad_(True)
    loss, metrics = LM(ref["cfg"], device="cpu").loss(params, ref["batch"])
    grads = torch.autograd.grad(loss, flat, allow_unused=True,
                                materialize_grads=True)
    return loss, metrics, grads


def loss_gaps(ref):
    loss, metrics, grads = _port_loss_and_grads(ref)
    flat = jax.tree_util.tree_flatten_with_path(ref["grads"])[0]
    assert len(flat) == len(grads)
    gaps = {jax.tree_util.keystr(path): _rel(g.numpy(), want)
            for (path, want), g in zip(flat, grads)}
    jm = ref["metrics"]
    return {"loss": abs(loss.item() - ref["loss"]) / abs(ref["loss"]),
            "metrics": sorted(metrics) == sorted(jm),
            "moe_load": np.array_equal(metrics["moe_load"].detach().numpy(),
                                       np.asarray(jm["moe_load"])),
            "moe_dropped": abs(float(metrics["moe_dropped"])
                               - float(jm["moe_dropped"])) <= ATOL_DROPPED,
            "grads": gaps}


def test_loss_metrics_and_every_gradient_leaf_match_jax(train_ref):
    """deepseek's reduced config: the cross entropy with the balance
    penalty and 0.3 x the MTP loss; ``moe_load`` exactly and
    ``moe_dropped`` within ATOL_DROPPED; every gradient leaf (the routing
    bias's is zero in both)."""
    g = loss_gaps(train_ref)
    assert g["metrics"] and g["moe_load"] and g["moe_dropped"]
    assert g["loss"] <= RTOL_LOSS
    worst = max(g["grads"], key=g["grads"].get)
    assert g["grads"][worst] <= RTOL_GRAD, (worst, g["grads"][worst])
    assert g["grads"]["['moe']['moe']['bias']"] == 0.0


def test_update_moe_bias_matches_jax(train_ref):
    """The bias moves by 1e-3 against the sign of each layer's load
    deviation, on the reference's load, bit for bit."""
    cfg = train_ref["cfg"]
    load = np.random.default_rng(5).dirichlet(
        np.ones(cfg.num_experts), size=3).astype(np.float32)
    load[0, :2] = load[0, :2].mean()       # a tie at the mean: sign 0
    want = jax_update_moe_bias(train_ref["jcfg"], train_ref["jparams"],
                               jnp.asarray(load))
    params = convert.lm_params_from_numpy(cfg, train_ref["np_params"],
                                          device="cpu")
    update_moe_bias(cfg, params, torch.from_numpy(load))
    got = params["moe"]["moe"]["bias"].numpy()
    assert np.array_equal(got, np.asarray(want["moe"]["moe"]["bias"]))
    assert (got != 0).any()


def train_gaps(ref, steps=3):
    kw = dict(base_lr=1e-3, warmup=2, total_steps=10)
    _, jstep = jax_make_train_step(ref["jcfg"], **kw)
    jstep = jax.jit(jstep)
    _, step = make_train_step(ref["cfg"], device="cpu", **kw)
    jparams, jopt = ref["jparams"], jax_adamw.adamw_init(ref["jparams"])
    params = convert.lm_params_from_numpy(ref["cfg"], ref["np_params"],
                                          device="cpu")
    opt = adamw.adamw_init(params)
    data = JaxData(ref["jcfg"], B, SEQ, seed=SEED)
    gaps = []
    for i in range(steps):
        batch = data.next_batch()
        jparams, jopt, jm = jstep(jparams, jopt, batch, i)
        params, opt, m = step(params, opt, batch, i)
        assert sorted(m) == sorted(jm)
        gaps.append({k: abs(float(m[k]) - float(jm[k]))
                     / max(abs(float(jm[k])), 1e-30) for k in RTOL_STEP})
        gaps[-1]["moe_dropped"] = abs(float(m["moe_dropped"])
                                      - float(jm["moe_dropped"]))
    bias = _rel(params["moe"]["moe"]["bias"].detach().numpy(),
                jparams["moe"]["moe"]["bias"])
    return gaps, bias


def test_three_train_steps_match_jax(train_ref):
    """make_train_step on deepseek's reduced config: loss, grad_norm, lr,
    moe_balance and moe_dropped each step; the routing bias after 3 steps
    (AdamW's decay, then update_moe_bias)."""
    gaps, bias = train_gaps(train_ref)
    for k, tol in RTOL_STEP.items():
        assert max(g[k] for g in gaps) <= tol, (k, gaps)
    assert max(g["moe_dropped"] for g in gaps) <= ATOL_DROPPED, gaps
    assert bias <= 1e-6


# ---------------------------------------------------------------------------
# the full-width configurations
# ---------------------------------------------------------------------------

# parameters of the unreduced trees (jax.eval_shape of the JAX LM.init)
N_PARAMS = {"moonshot-v1-16b-a3b": 27_980_010_432,
            "deepseek-v3-671b": 682_636_487_424}


@pytest.mark.parametrize("arch", ["moonshot-v1-16b-a3b", "deepseek-v3-671b",
                                  "qwen3-8b", "qwen3-32b", "granite-34b",
                                  "internlm2-1.8b"])
def test_full_width_parameter_tree_matches_jax(arch):
    """Every name, shape and dtype of the unreduced tree against the
    reference's (the float32 router and bias included), without allocating
    either."""
    spec = LM(get_config(arch), device="meta").init()
    jspec = jax.eval_shape(JaxLM(jax_get_config(arch)).init,
                           jax.random.key(0))
    mine = {p: (tuple(t.shape), str(t.dtype).replace("torch.", ""))
            for p, t in _leaves(spec)}
    theirs = {p: (tuple(t.shape), str(t.dtype)) for p, t in _leaves(jspec)}
    assert mine == theirs
    n_params = sum(int(np.prod(s)) for s, _ in mine.values())
    assert n_params == N_PARAMS.get(arch, n_params)
    if get_config(arch).moe:
        assert mine["/moe/moe/router"][1] == mine["/moe/moe/bias"][1] \
            == "float32"


@pytest.mark.parametrize("arch", ["hymba-1.5b", "deepseek-v3-671b"])
def test_init_fills_stacked_leaves_in_the_per_layer_draw_order(arch):
    """``LM.init`` fills each stacked leaf a layer at a time: the same
    draws, in the same order, as stacking whole per-layer trees (so a
    seed gives the weights it gave before)."""
    from repro_torch.models import lm as lm_mod
    cfg = reduce_config(get_config(arch))
    got = LM(cfg, device="cpu").init(torch.Generator().manual_seed(4))
    g = torch.Generator().manual_seed(4)
    stack_orig = lm_mod._init_stacked
    try:
        lm_mod._init_stacked = lambda n, draw: lm_mod._stack(
            [draw() for _ in range(n)])
        want = LM(cfg, device="cpu").init(g)
    finally:
        lm_mod._init_stacked = stack_orig
    mine, theirs = dict(_leaves(got)), dict(_leaves(want))
    assert sorted(mine) == sorted(theirs)
    assert all(torch.equal(mine[k], theirs[k]) for k in mine)


def test_large_leaves_are_drawn_in_pieces(monkeypatch):
    """A leaf above ``DRAW_PIECE`` elements is drawn in pieces of its first
    axis into its dtype: truncated at 2 std, the same from the same seed,
    and the same as drawing the pieces one by one."""
    from repro_torch.models import common
    monkeypatch.setattr(common, "DRAW_PIECE", 1000)
    draw = [common.dense_init(torch.Generator().manual_seed(1), (7, 40, 30),
                              torch.bfloat16, "cpu") for _ in range(2)]
    assert draw[0].dtype == torch.bfloat16 and draw[0].shape == (7, 40, 30)
    assert torch.equal(draw[0], draw[1])
    std = 1.0 / np.sqrt(40)
    assert draw[0].float().abs().max() <= 2 * std * (1 + 2 ** -7)
    g = torch.Generator().manual_seed(1)
    pieces = torch.cat([common._draw(g, (1, 40, 30), "cpu", std,
                                     torch.bfloat16) for _ in range(7)])
    assert torch.equal(pieces, draw[0])


def test_registered_configs_are_the_references():
    from repro.configs import ALL_ARCHS
    from repro_torch.configs import list_archs
    assert list_archs() == ALL_ARCHS
    for arch in ALL_ARCHS:
        cfg, jcfg = get_config(arch), jax_get_config(arch)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg), arch
        assert dataclasses.asdict(reduce_config(cfg)) == dataclasses.asdict(
            jax_reduce_config(jcfg)), arch


if __name__ == "__main__":
    for arch in ARCHS:
        m = _models(arch)
        logit_gap, gaps = _prefill_gaps(m)
        print(f"{arch} prefill: logits {logit_gap:.3e}, worst cache leaf "
              f"{max(gaps.values()):.3e} ({max(gaps, key=gaps.get)})")
        logit_gap, gaps = _decode_gaps(m)
        print(f"{arch} teacher-forced decode: logits {logit_gap:.3e}, worst "
              f"cache leaf {max(gaps.values()):.3e}")
    print(f"moe_block overflowing: {moe_gaps()}")
    ref = _train_ref()
    g = loss_gaps(ref)
    worst = max(g["grads"], key=g["grads"].get)
    print(f"deepseek loss {g['loss']:.3e}, metrics equal "
          f"{g['moe_load'], g['moe_dropped']}, worst gradient "
          f"{g['grads'][worst]:.3e} ({worst})")
    gaps, bias = train_gaps(ref)
    print(f"3 train steps: {gaps}; bias {bias:.3e}")
