"""The dense family (internlm2-1.8b: GQA; qwen3-8b and qwen3-32b: qk-norm
and GQA; granite-34b: MQA and the tanh-GELU MLP) of the PyTorch port
against the JAX package, on the CPU, at the reduced configurations
(``reduce_config``: 4 layers, d_model 64, 4 heads of 16 on 2 kv heads, one
for granite, float32) with the JAX weights carried across by
``convert.lm_params_from_numpy``: the prefill's logits and every cache
leaf, the ``Engine``'s greedy tokens, and the loss and every gradient leaf
against ``jax.value_and_grad`` (qk-norm's and GELU's backward, and MQA's
gradient through its one kv head, among them).

Every float check is ``max|port - jax| <= RTOL * max|jax|`` over a tensor.
Measured against live JAX (``python tests/test_torch_dense.py`` prints
them): prefill logits within 6.2e-6 and cache leaves within 6.7e-6; the
loss within 7.1e-7. The gradients' gap grows with depth, as hymba's does
(tests/test_torch_train.py), as float32 rounding is carried back through
the random-weight layers: 4.2e-6 (internlm2) and 4.0e-6 (granite) at 1
layer, 3.2e-5 / 5.5e-5 at 2, 2.1e-4 / 3.7e-4 at the reduced configs' 4
(JAX's own gradients move by 9.7e-5 / 3.5e-5 at 4 layers when only its
attention blocking changes, 16 vs 8); qwen3's qk-norm bounds the scores,
and its gap stays at 1.7e-6. Served as ``chip_smoke.py`` phase 39 serves
them (the port's weights, 4 x 40-token prompts, 24 greedy steps), the
logits of the models without qk-norm carry float32 rounding near 1e-4:
the port is 3.6e-4 (internlm2) / 2.8e-4 (granite) from JAX there, and
JAX's own logits move by 2.4e-4 / 1.4e-4 when every weight moves by half
an ulp (qwen3: 5.6e-7 and 7.7e-7). The gates: RTOL 1e-4 for logits and caches
and RTOL_LOSS 1e-6, as tests/test_torch_moe.py; RTOL_GRAD by depth, 5e-5
at 1 layer and 2e-3 at 4 (tests/test_torch_train.py's gate at 4 layers).
Greedy tokens must be identical.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduce_config as jax_reduce_config
from repro.data.pipeline import SyntheticLMData as JaxData
from repro.models import LM as JaxLM
from repro.serve.engine import Engine as JaxEngine
from repro_torch import convert
from repro_torch.configs import get_config, reduce_config
from repro_torch.models import LM
from repro_torch.optim import adamw
from repro_torch.serve.engine import Engine

RTOL = 1e-4              # prefill logits and every cache leaf
RTOL_LOSS = 1e-6
RTOL_GRAD = {1: 5e-5, 4: 2e-3}     # by depth
ARCHS = ["internlm2-1.8b", "qwen3-8b", "qwen3-32b", "granite-34b"]
B, SEQ, SEED = 4, 24, 3            # the training batch


def _jax_side(arch, depth=4):
    jcfg = jax_reduce_config(jax_get_config(arch)).replace(num_layers=depth)
    jlm = JaxLM(jcfg)
    jparams = jax.jit(jlm.init)(jax.random.key(0))
    batch = JaxData(jcfg, B, SEQ, seed=SEED).next_batch()
    (loss, _), grads = jax.jit(jax.value_and_grad(
        lambda p, b: jlm.loss(p, b), has_aux=True))(jparams, batch)
    cfg = reduce_config(get_config(arch)).replace(num_layers=depth)
    return {"jcfg": jcfg, "jlm": jlm, "jparams": jparams, "cfg": cfg,
            "np_params": jax.tree.map(np.asarray, jparams), "batch": batch,
            "loss": float(loss), "grads": grads}


@pytest.fixture(scope="module", params=ARCHS)
def ref(request):
    return _jax_side(request.param)


def _params(ref):
    return convert.lm_params_from_numpy(ref["cfg"], ref["np_params"],
                                        device="cpu")


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
    return float(np.abs(got - want).max() / np.abs(want).max())


def prefill_gaps(ref, S0=12, max_seq=24):
    toks = np.random.default_rng(S0).integers(
        0, ref["cfg"].vocab_size, (2, S0)).astype(np.int32)
    jcache, jlogits = jax.jit(lambda p, b: ref["jlm"].prefill(
        p, b, max_seq=max_seq))(ref["jparams"], {"tokens": toks})
    with torch.inference_mode():
        cache, logits = LM(ref["cfg"], device="cpu").prefill(
            _params(ref), {"tokens": toks}, max_seq=max_seq)
    mine, theirs = dict(_leaves(cache)), dict(_leaves(jcache))
    assert sorted(mine) == sorted(theirs)
    assert mine["/pos"] == int(theirs["/pos"])
    return _rel(logits.numpy(), jlogits), {
        p: _rel(mine[p].numpy(), w) for p, w in theirs.items() if p != "/pos"}


def test_prefill_logits_and_every_cache_leaf_match_jax(ref):
    logit_gap, cache_gaps = prefill_gaps(ref)
    assert logit_gap <= RTOL
    assert max(cache_gaps.values()) <= RTOL, cache_gaps


def test_engine_greedy_tokens_match_jax(ref):
    toks = np.random.default_rng(0).integers(
        0, ref["cfg"].vocab_size, (3, 10)).astype(np.int32)
    want = JaxEngine(ref["jcfg"], ref["jparams"], max_seq=32).generate(
        {"tokens": toks}, steps=12)
    got = Engine(ref["cfg"], _params(ref), max_seq=32, device="cpu").generate(
        {"tokens": toks}, steps=12)
    assert got.dtype == np.int32 and got.shape == (3, 12)
    assert np.array_equal(got, want)


def loss_gaps(ref):
    params = _params(ref)
    flat = adamw.leaves(params)
    for t in flat:
        t.requires_grad_(True)
    loss, _ = LM(ref["cfg"], device="cpu").loss(params, ref["batch"])
    grads = torch.autograd.grad(loss, flat)
    want = jax.tree_util.tree_flatten_with_path(ref["grads"])[0]
    assert len(want) == len(grads)
    return abs(loss.item() - ref["loss"]) / abs(ref["loss"]), {
        jax.tree_util.keystr(path): _rel(g.numpy(), w)
        for (path, w), g in zip(want, grads)}


def _check_loss_and_gradients(ref):
    loss_gap, grad_gaps = loss_gaps(ref)
    assert loss_gap <= RTOL_LOSS
    worst = max(grad_gaps, key=grad_gaps.get)
    cfg = ref["cfg"]
    gate = RTOL_GRAD[cfg.num_layers]
    assert grad_gaps[worst] <= gate, (worst, grad_gaps[worst])
    names = " ".join(grad_gaps)
    assert ("q_norm" in names and "k_norm" in names) == cfg.qk_norm
    assert ("'wi'" in names) == (cfg.mlp_type == "gelu")


def test_loss_and_every_gradient_leaf_match_jax(ref):
    """The cross entropy and the gradient of every leaf at the reduced
    configs' 4 layers: qwen3's q_norm / k_norm, granite's GELU ``wi`` and
    its one kv head's ``wk`` / ``wv``."""
    _check_loss_and_gradients(ref)


@pytest.mark.parametrize("arch", ARCHS)
def test_one_layer_gradients_match_jax_tightly(arch):
    """At 1 layer, where no depth carries the rounding, the gradients meet
    a gate 40x tighter: a fault in qk-norm's, GELU's or MQA's backward
    would show here."""
    _check_loss_and_gradients(_jax_side(arch, depth=1))


def serve_noise_gaps(arch, seed=0, steps=24):
    """chip_smoke.py phase 39's serving run on the CPU: the port's reduced
    weights drawn from ``seed``, 4 x 40-token prompts from numpy's
    ``default_rng(seed)``, ``steps`` greedy decode steps. Returns (max over
    the steps' logits of |port - jax| / max|jax|, the same for JAX with
    every weight moved by half a float32 ulp against JAX), both decoding
    the port's tokens."""
    cfg = reduce_config(get_config(arch))
    params = LM(cfg, device="cpu").init(torch.Generator().manual_seed(seed))
    np_params = convert.lm_params_to_numpy(params)
    toks = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (4, 40)).astype(np.int32)
    lm, port, fed = LM(cfg, device="cpu"), [], []
    with torch.inference_mode():
        cache, logits = lm.prefill(params, {"tokens": toks}, max_seq=64)
        port.append(logits.numpy())
        for _ in range(steps):
            fed.append(logits.argmax(-1).to(torch.int32))
            logits, cache = lm.decode(params, cache, {"tokens": fed[-1]})
            port.append(logits.numpy())
    jlm = JaxLM(jax_reduce_config(jax_get_config(arch)))
    signs = np.random.default_rng(seed + 1)

    def run(tree):
        cache, logits = jax.jit(lambda p, b: jlm.prefill(p, b, max_seq=64))(
            tree, {"tokens": toks})
        out, decode = [np.asarray(logits)], jax.jit(jlm.decode)
        for t in fed:
            logits, cache = decode(tree, cache, {"tokens": t.numpy()})
            out.append(np.asarray(logits))
        return out
    want = run(np_params)
    nudged = run(jax.tree.map(lambda a: (a * (1 + signs.choice(
        [-1.0, 1.0], a.shape) * 2.0 ** -24)).astype(a.dtype)
        if a.dtype == np.float32 else a, np_params))
    return (max(_rel(a, b) for a, b in zip(port, want)),
            max(_rel(a, b) for a, b in zip(nudged, want)))


if __name__ == "__main__":      # print the measured gaps
    for arch in ARCHS:
        r = _jax_side(arch)
        logit_gap, cache_gaps = prefill_gaps(r)
        print(f"{arch}: prefill logits {logit_gap:.2e}, worst cache leaf "
              f"{max(cache_gaps.values()):.2e}")
        for depth in (1, 2, 4):
            loss_gap, grad_gaps = loss_gaps(_jax_side(arch, depth))
            worst = max(grad_gaps, key=grad_gaps.get)
            print(f"  {depth} layers: loss {loss_gap:.2e}, worst gradient "
                  f"{worst} {grad_gaps[worst]:.2e}")
        port_gap, noise = serve_noise_gaps(arch)
        print(f"  serving as chip_smoke.py phase 39 (port weights, 24 "
              f"steps): port vs JAX {port_gap:.2e}; JAX with its weights "
              f"moved by half an ulp {noise:.2e}")
