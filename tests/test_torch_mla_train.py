"""MLA training in the PyTorch port against the JAX package, on the CPU:
the gradient that the attention backward kernel computes on the card at
MLA's head dims (query/key ``Dqk`` apart from value ``Dv``), and the
training step of deepseek-v3 cut as ``chip_smoke.py`` trains it.

- ``ref.attention_ref_grads`` (the backward kernel's plain version) at
  (Dqk, Dv) = (24, 16), the reduced MLA's, and (192, 128), deepseek-v3's
  (also at S = 64 and 65, either side of the (192, 128) kernel's 64-row
  tile edge), causal, against ``jax.vjp`` of
  ``repro.models.attention.causal_attention``
  on the same numpy inputs: every gradient within ``RTOL_GRAD`` of JAX's
  (``max|port - jax| <= RTOL * max|jax|``, float32);
- the wrapper's padding (``kernels.flash_attention._pad_qk``: q and k
  padded with zero columns to the kernel's 32, scaled by 1/sqrt(24)): the
  gradients through the padded plain version, sliced back, equal the
  unpadded ones, and the padded columns' are zero;
- three ``make_train_step`` steps of the reduced deepseek-v3 cut to two
  layers without MTP (one dense, one MoE) against the JAX step from the
  same weights and batches: loss and grad_norm within
  ``tests/test_torch_moe.py``'s ``RTOL_STEP``;
- the cut that ``chip_smoke.py`` trains at full width (phase 33: two
  dense layers, so an empty MoE segment, no MTP) trains on the port to
  finite losses with no MoE metric. The JAX package's loss is NaN there:
  it averages the balance penalty and the dropped share over the empty
  segment's loads, so that cut has no reference to be held to.

    PYTHONPATH=src python -m pytest tests/test_torch_mla_train.py
    PYTHONPATH=src python tests/test_torch_mla_train.py   # prints the gaps
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduce_config as jax_reduce_config
from repro.data.pipeline import SyntheticLMData as JaxData
from repro.models import LM as JaxLM
from repro.models.attention import causal_attention as jax_causal_attention
from repro.optim import adamw as jax_adamw
from repro.train.step import make_train_step as jax_make_train_step
from repro_torch import convert
from repro_torch.configs import get_config, reduce_config
from repro_torch.data.pipeline import SyntheticLMData
from repro_torch.kernels import flash_attention as kflash
from repro_torch.kernels import ref
from repro_torch.optim import adamw
from repro_torch.train.step import init_train_state, make_train_step

RTOL_GRAD = 1e-5
RTOL_STEP = {"loss": 1e-5, "grad_norm": 1e-4}   # tests/test_torch_moe.py's
# (B, H, S, Dqk, Dv): the reduced MLA and deepseek-v3's head dims, the
# latter also at S = 64 and 65, the edges of the card kernel's 64-row tiles
GRAD_CASES = [(2, 4, 40, 24, 16), (1, 4, 70, 192, 128), (1, 2, 64, 192, 128),
              (1, 2, 65, 192, 128)]
GRAD_IDS = ["24-16", "192-128", "192-128-S64", "192-128-S65"]
# two layers (the reduced config's one dense, one MoE), no MTP module;
# phase 33's cut keeps two dense layers
MLA_CUT = {"num_layers": 2, "mtp": False}
DENSE_CUT = {"num_layers": 2, "first_dense_layers": 2, "mtp": False}
B, SEQ, SEED = 4, 24, 3


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _inputs(B, H, S, D, Dv, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32) for shape in
            ((B, H, S, D), (B, H, S, D), (B, H, S, Dv), (B, H, S, Dv))]


def _jax_grads(q, k, v, do):
    """jax.vjp of the model's blocked causal attention, in the port's
    (B, H, S, D) layout (one kv head a query head, as MLA expands them)."""
    def attend(q, k, v):
        o = jax_causal_attention(
            jnp.transpose(q, (0, 2, 1, 3))[:, :, :, None, :],
            jnp.transpose(k, (0, 2, 1, 3)), jnp.transpose(v, (0, 2, 1, 3)),
            jnp.arange(q.shape[2]))
        return jnp.transpose(o, (0, 2, 1, 3))
    _, vjp = jax.vjp(attend, *(jnp.asarray(t) for t in (q, k, v)))
    return vjp(jnp.asarray(do))


@pytest.mark.parametrize("case", GRAD_CASES, ids=GRAD_IDS)
def test_plain_mla_gradients_match_jax(case):
    """dq, dk, dv of ``attention_ref`` at Dqk != Dv against JAX's."""
    q, k, v, do = _inputs(*case)
    got = ref.attention_ref_grads(*(torch.from_numpy(t) for t in (q, k, v,
                                                                  do)))
    for g, w, name in zip(got, _jax_grads(q, k, v, do), "qkv"):
        assert g.shape == w.shape
        assert _rel(g.numpy(), w) <= RTOL_GRAD, name


def test_padding_path_gives_the_unpadded_gradients():
    """q, k of width 24 padded to the kernel's 32 as the card's wrapper
    pads them: the padded columns' gradients are zero, and the rest equal
    the unpadded gradients."""
    Bn, H, S, D, Dv = GRAD_CASES[0]
    q, k, v, do = (torch.from_numpy(t) for t in _inputs(Bn, H, S, D, Dv))
    assert kflash.kernel_dim(D, Dv) == 32
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    qp, kp = kflash._pad_qk(leaves[0], leaves[1], Dv)
    assert qp.shape[-1] == kp.shape[-1] == 32
    qp, kp = (t.detach().requires_grad_(True) for t in (qp, kp))
    o = ref.attention_ref(qp, kp, leaves[2], round_p=False,
                          scale=1.0 / math.sqrt(D))
    dqp, dkp, dv = torch.autograd.grad(o, (qp, kp, leaves[2]), do)
    assert not dqp[..., D:].any() and not dkp[..., D:].any()
    want = ref.attention_ref_grads(q, k, v, do)
    for g, w in zip((dqp[..., :D], dkp[..., :D], dv), want):
        assert _rel(g.numpy(), w.numpy()) <= RTOL_GRAD


def _cut_cfgs():
    return (jax_reduce_config(jax_get_config("deepseek-v3-671b")).replace(
                **MLA_CUT),
            reduce_config(get_config("deepseek-v3-671b")).replace(**MLA_CUT))


def step_gaps(steps=3):
    """Per step, the port's loss and grad_norm against the JAX step's,
    relative, from the same weights and batches."""
    jcfg, cfg = _cut_cfgs()
    kw = dict(base_lr=1e-3, warmup=2, total_steps=10)
    _, jstep = jax_make_train_step(jcfg, **kw)
    jstep = jax.jit(jstep)
    _, step = make_train_step(cfg, device="cpu", **kw)
    jparams = jax.jit(JaxLM(jcfg).init)(jax.random.key(0))
    jopt = jax_adamw.adamw_init(jparams)
    params = convert.lm_params_from_numpy(
        cfg, jax.tree.map(np.asarray, jparams), device="cpu")
    opt = adamw.adamw_init(params)
    data = JaxData(jcfg, B, SEQ, seed=SEED)
    gaps = []
    for i in range(steps):
        batch = data.next_batch()
        jparams, jopt, jm = jstep(jparams, jopt, batch, i)
        params, opt, m = step(params, opt, batch, i)
        gaps.append({k: abs(float(m[k]) - float(jm[k])) / abs(float(jm[k]))
                     for k in RTOL_STEP})
    return gaps


def test_three_steps_of_the_cut_deepseek_match_jax():
    gaps = step_gaps()
    for k, tol in RTOL_STEP.items():
        assert max(g[k] for g in gaps) <= tol, (k, gaps)


def test_two_dense_layers_train_to_finite_losses():
    """Phase 33's cut at the reduced width: an empty MoE segment, three
    steps, every loss and grad_norm finite and no MoE metric."""
    cfg = reduce_config(get_config("deepseek-v3-671b")).replace(**DENSE_CUT)
    _, step = make_train_step(cfg, device="cpu", base_lr=1e-3, warmup=2,
                              total_steps=10)
    params, opt = init_train_state(cfg, torch.Generator().manual_seed(0),
                                   device="cpu")
    data = SyntheticLMData(cfg, B, SEQ, SEED)
    for i in range(3):
        params, opt, m = step(params, opt, data.next_batch(), i)
        assert math.isfinite(float(m["loss"]))
        assert math.isfinite(float(m["grad_norm"]))
        assert "moe_balance" not in m and "moe_dropped" not in m


if __name__ == "__main__":
    for case in GRAD_CASES:
        q, k, v, do = _inputs(*case)
        got = ref.attention_ref_grads(*(torch.from_numpy(t)
                                        for t in (q, k, v, do)))
        print(f"attention_ref_grads {case} vs JAX:",
              [f"{_rel(g.numpy(), w):.3e}"
               for g, w in zip(got, _jax_grads(q, k, v, do))])
    print("3 steps of the cut deepseek vs JAX:", step_gaps())
