"""The flash-attention plain version of the PyTorch port (what the wrapper
runs on the CPU and what the CUDA kernel is held to on the card) against the
JAX reference.

With p rounded to v's dtype (``round_p=True``, the default) it is held to
the reference's Pallas kernel in interpret mode and its oracle
``repro.kernels.ref.attention_ref``, at the reference's own gate for its
kernel (``tests/test_kernels.py``): 2e-5 for float32 and 2e-2 for bfloat16,
atol and rtol alike. Measured worst case on the CPU at the reference's
shapes: 7.2e-7 for float32 and 7.8e-3 for bfloat16 (max abs err).

With p kept in float32 (``round_p=False``, what the port's model calls, with
its window and sink) it is held to the JAX model's blocked attention
``repro.models.attention.causal_attention``:

- float32: ``|port - jax| <= 2e-6 * (|jax| + max|jax|)`` elementwise
  (elementwise relative error alone is meaningless where the weighted sum of
  v cancels to near zero); measured worst 3.0e-7 of max|jax|;
- bfloat16: every element within one bf16 ulp of the larger of the two
  values, magnitudes below 2^-10 * max|jax| counted as 2^-10 * max|jax|
  (float32 rounding in the accumulator is relative to the output's scale,
  so an element that cancels to near zero can move by several of its own
  ulps: measured up to 11), and at most 1 % of the elements differing at
  all; measured worst share 0.04 %, and 1 ulp.

Gradients: the wrapper on the CPU (the plain version under autograd)
against ``jax.grad`` of the JAX model's ``causal_attention`` (GQA, window,
sink, several q chunks), float32, within ``RTOL_GRAD`` of max|jax|.

``python tests/test_torch_flash_attention.py`` prints the measured gaps.
"""
import dataclasses
import re
import sys
from collections import Counter
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduce_config as jax_reduce_config
from repro.kernels.flash_attention import flash_attention as jax_flash
from repro.kernels.ref import attention_ref as jax_attention_ref
from repro.models import LM as JaxLM
from repro.models import attention as jax_attn
from repro_torch import convert
from repro_torch.configs import get_config, reduce_config
from repro_torch.kernels import flash_attention as kflash
from repro_torch.kernels import ref
from repro_torch.models import attention as attn

TOL = {"f32": 2e-5, "bf16": 2e-2}
JNP = {"f32": jnp.float32, "bf16": jnp.bfloat16}
TORCH = {"f32": torch.float32, "bf16": torch.bfloat16}


def _inputs(shape_q, shape_kv, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=shape_q).astype(np.float32),
            rng.normal(size=shape_kv).astype(np.float32),
            rng.normal(size=shape_kv).astype(np.float32))


def _port(arrays, dtype, causal):
    q, k, v = (torch.from_numpy(a).to(TORCH[dtype]) for a in arrays)
    return ref.attention_ref(q, k, v, causal=causal).float().numpy()


def _err(got, want):
    return float(np.max(np.abs(got - np.asarray(want, np.float32))))


@pytest.mark.parametrize("shape", [(1, 2, 256, 64), (2, 1, 128, 128),
                                   (1, 4, 512, 64), (2, 2, 256, 96)],
                         ids=str)
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_plain_version_matches_pallas_kernel_and_oracle(shape, dtype, causal):
    arrays = _inputs(shape, shape, 0)
    got = _port(arrays, dtype, causal)
    q, k, v = (jnp.asarray(a, JNP[dtype]) for a in arrays)
    pallas = jax_flash(q, k, v, causal=causal, interpret=True)
    oracle = jax_attention_ref(q, k, v, causal=causal)
    assert _err(got, pallas) <= TOL[dtype]
    assert _err(got, oracle) <= TOL[dtype]


@pytest.mark.parametrize("bq,bk", [(128, 128), (64, 128), (128, 64)])
def test_plain_version_matches_pallas_block_shapes(bq, bk):
    arrays = _inputs((1, 2, 256, 64), (1, 2, 256, 64), 1)
    q, k, v = (jnp.asarray(a) for a in arrays)
    pallas = jax_flash(q, k, v, causal=True, block_q=bq, block_k=bk,
                       interpret=True)
    assert _err(_port(arrays, "f32", True), pallas) <= TOL["f32"]


# (B, H, K, S, D): grouped-query heads and sequence lengths no block
# divides (the Pallas kernel asserts S % block == 0, so these go to the
# oracle; GQA goes to the Pallas kernel on K/V repeated to H heads)
GQA_RAGGED = [(1, 6, 2, 128, 32), (2, 4, 1, 256, 64), (2, 4, 4, 200, 64),
              (1, 5, 5, 77, 16), (1, 25, 5, 150, 64)]


@pytest.mark.parametrize("shape", GQA_RAGGED, ids=str)
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_plain_version_gqa_and_ragged(shape, dtype, causal):
    B, H, K, S, D = shape
    arrays = _inputs((B, H, S, D), (B, K, S, D), 2)
    got = _port(arrays, dtype, causal)
    q, k, v = (jnp.asarray(a, JNP[dtype]) for a in arrays)
    k, v = (jnp.repeat(t, H // K, axis=1) for t in (k, v))
    want = (jax_flash(q, k, v, causal=causal, interpret=True)
            if S % 128 == 0 else jax_attention_ref(q, k, v, causal=causal))
    assert _err(got, want) <= TOL[dtype]


# ---------------------------------------------------------------------------
# p in float32 with window and sink: the JAX model's attention
# ---------------------------------------------------------------------------

RTOL_F32 = 2e-6
MAX_SHARE_BF16 = 0.01        # elements allowed to differ at all


def bf16_ulp_gaps(got, want):
    """``ref.bf16_ulp_gaps`` of two numpy arrays of bf16 values."""
    return ref.bf16_ulp_gaps(torch.tensor(np.asarray(got, np.float32)),
                             torch.tensor(np.asarray(want, np.float32)))


def test_bf16_ulp_gaps_counts_in_ulps_of_the_floored_magnitude():
    want = torch.tensor([1.0, 0.5, 1e-6, 0.0]).bfloat16()
    one_ulp = torch.tensor([1.0 + 2 ** -7, 0.5, 1e-6, 0.0]).bfloat16()
    assert ref.bf16_ulp_gaps(one_ulp, want) == (1.0, 0.25)
    # 1e-6 -> 2e-6 is ~130 of its own ulps, 0.13 ulp of the floor 2^-10 *
    # max|want| (whose ulp is 2^-17)
    tiny = torch.tensor([1.0, 0.5, 2e-6, 0.0]).bfloat16()
    ulps, share = ref.bf16_ulp_gaps(tiny, want)
    assert 0.1 < ulps < 0.2 and share == 0.25
    assert ref.bf16_ulp_gaps(want, want) == (0.0, 0.0)


def assert_bf16_close(got, want):
    ulps, share = bf16_ulp_gaps(got, want)
    assert ulps <= 1.0 and share <= MAX_SHARE_BF16, (ulps, share)


def assert_f32_close(got, want):
    want = np.asarray(want, np.float64)
    gap = np.abs(np.asarray(got, np.float64) - want)
    assert (gap <= RTOL_F32 * (np.abs(want) + np.abs(want).max())).all(), \
        gap.max() / np.abs(want).max()


def _model_inputs(B, S, K, G, hd, seed, scale=1.0):
    """q (B,S,K,G,hd), k/v (B,S,K,hd), unit normal times ``scale``."""
    rng = np.random.default_rng(seed)
    return tuple((scale * rng.normal(size=shape)).astype(np.float32)
                 for shape in ((B, S, K, G, hd), (B, S, K, hd),
                               (B, S, K, hd)))


def _jax_model_attention(q, k, v, dtype, window, sink):
    S = q.shape[1]
    o = jax_attn.causal_attention(
        *(jnp.asarray(a, JNP[dtype]) for a in (q, k, v)), jnp.arange(S),
        window=window, sink=sink)
    return np.asarray(o.astype(jnp.float32))


def _to_heads(q, k, v, dtype):
    """The model layout (B,S,K,G,hd) / (B,S,K,hd) -> the kernel's
    (B,H,S,D) / (B,K,S,D) torch tensors."""
    B, S, K, G, hd = q.shape
    return (torch.from_numpy(q).to(TORCH[dtype]).reshape(B, S, K * G, hd)
            .transpose(1, 2).contiguous(),
            *(torch.from_numpy(a).to(TORCH[dtype]).transpose(1, 2)
              .contiguous() for a in (k, v)))


# (B, S, K, G, hd, window, sink): GQA; a ragged S; window < S with a sink
# that no tile boundary meets; window >= S; hymba's window 1,024 with 128
# meta tokens at reduced width (S = 128 meta + 1,000 text tokens, 1 kv head
# of 2 q heads, hd 16)
MODEL_CASES = [(2, 128, 2, 3, 32, None, 0), (1, 130, 1, 4, 64, None, 0),
               (1, 300, 2, 2, 32, 100, 20), (1, 200, 2, 2, 16, 1000, 16),
               (1, 1128, 1, 2, 16, 1024, 128)]


@pytest.mark.parametrize("case", MODEL_CASES, ids=str)
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_float32_p_matches_the_jax_model_attention(case, dtype):
    B, S, K, G, hd, window, sink = case
    q, k, v = _model_inputs(B, S, K, G, hd, 4)
    got = ref.attention_ref(*_to_heads(q, k, v, dtype), causal=True,
                            window=window, sink=sink, round_p=False)
    got = got.transpose(1, 2).float().numpy()
    want = _jax_model_attention(q, k, v, dtype, window, sink)
    (assert_f32_close if dtype == "f32" else assert_bf16_close)(got, want)


@pytest.mark.parametrize("case", MODEL_CASES[2:], ids=str)
def test_port_causal_attention_matches_the_jax_model(case):
    """The port's ``causal_attention`` (the layout wrapper the model calls)
    against the JAX function of the same name, bf16, at 3x unit scale."""
    B, S, K, G, hd, window, sink = case
    q, k, v = _model_inputs(B, S, K, G, hd, 5, scale=3.0)
    got = attn.causal_attention(
        *(torch.from_numpy(a).bfloat16() for a in (q, k, v)),
        torch.arange(S), window=window, sink=sink)
    assert got.dtype == torch.bfloat16 and got.shape == (B, S, K * G, hd)
    assert_bf16_close(got.float().numpy(),
                      _jax_model_attention(q, k, v, "bf16", window, sink))


# (B, S, H, Dqk, Dv): MLA's value head dim apart from its query/key one:
# the reduced deepseek-v3's (24, 16), whose q and k the kernel wrapper pads
# to 32 (``kernel_dim``), and the full width's (192, 128) on a ragged S
MLA_CASES = [(2, 40, 4, 24, 16), (1, 130, 3, 192, 128)]


@pytest.mark.parametrize("case", MLA_CASES, ids=str)
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_mla_head_dims_and_padding_match_the_jax_model(case, dtype):
    """The plain version with Dv != Dqk, and again with q and k padded with
    zeros to the kernel's D and the unpadded Dqk's scale passed, against the
    JAX model's ``causal_attention`` (MLA calls it with K = H, G = 1): the
    gates of ``test_float32_p_matches_the_jax_model_attention``."""
    B, S, H, Dqk, Dv = case
    rng = np.random.default_rng(8)
    q, k = (rng.normal(size=(B, S, H, Dqk)).astype(np.float32)
            for _ in range(2))
    v = rng.normal(size=(B, S, H, Dv)).astype(np.float32)
    want = _jax_model_attention(q[:, :, :, None], k, v, dtype, None, 0)
    tq, tk, tv = (torch.from_numpy(a).to(TORCH[dtype]).transpose(1, 2)
                  .contiguous() for a in (q, k, v))
    D = kflash.kernel_dim(Dqk, Dv)
    assert (D, Dv) in kflash.HEAD_DIM_PAIRS and D >= Dqk
    pad = (0, D - Dqk)
    for got in (ref.attention_ref(tq, tk, tv, round_p=False),
                ref.attention_ref(torch.nn.functional.pad(tq, pad),
                                  torch.nn.functional.pad(tk, pad), tv,
                                  round_p=False,
                                  scale=1.0 / np.sqrt(Dqk))):
        assert got.shape == (B, H, S, Dv)
        got = got.transpose(1, 2).float().numpy()
        (assert_f32_close if dtype == "f32" else assert_bf16_close)(got, want)


def _hymba_heads_layer(S, seed=6):
    """(cfg, params, x) of a global layer with hymba-1.5b's attention heads
    (25 q on 5 kv, hd 64) and d_model = 25 * 64, bf16: wq, wk, wv normal
    over sqrt(d_model), so that q, k and v are about unit normal, and wo
    the identity, so that the block hands the attention out unchanged."""
    cfg = reduce_config(get_config("hymba-1.5b")).replace(
        dtype="bfloat16", num_heads=25, num_kv_heads=5, head_dim=64,
        d_model=1600)
    d, H, K, hd = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                   cfg.head_dim)
    rng = np.random.default_rng(seed)

    def w(*shape):
        return torch.from_numpy((rng.normal(size=shape) / np.sqrt(d))
                                .astype(np.float32)).bfloat16()
    p = {"wq": w(d, H, hd), "wk": w(d, K, hd), "wv": w(d, K, hd),
         "wo": torch.eye(d, dtype=torch.bfloat16).reshape(H, hd, d)}
    x = torch.from_numpy(rng.normal(size=(1, S, d)).astype(
        np.float32)).bfloat16()
    return cfg, p, x


def test_global_layer_keeps_p_in_float32_as_the_jax_model_does():
    """The repaired fault: at bf16 the port's global-attention layers went
    through the kernel with p rounded to bf16, the TPU kernel's choice,
    while the JAX model (``causal_attention``) keeps p in float32. Here
    ``attn_block`` of a global layer (window None), with ``wo`` the
    identity, is held to the JAX ``causal_attention`` on the port's own q,
    k and v. Before the repair 36.6 % of the elements differed, by up to 65
    ulps as ``bf16_ulp_gaps`` counts them (hymba's heads, S = 256, bf16);
    now at most 1 % may differ, by at most one ulp (measured: 0.02 %, 1)."""
    S = 256
    cfg, p, x = _hymba_heads_layer(S)
    positions = torch.arange(S)
    out, _ = attn.attn_block(p, x, cfg, positions)
    q, k, v = attn._qkv(p, x, cfg, positions)
    want = _jax_model_attention(*(t.float().numpy() for t in (q, k, v)),
                                "bf16", None, 0)
    assert_bf16_close(out.float().numpy(), want.reshape(1, S, cfg.d_model))


@pytest.fixture(scope="module")
def bf16_models():
    """The reduced hymba in bf16 (d_model 64, 4 q heads on 2 kv heads, hd
    16, window 16, 4 meta tokens), JAX weights carried to the port by
    ``convert``."""
    import jax
    jcfg = dataclasses.replace(
        jax_reduce_config(jax_get_config("hymba-1.5b")), dtype="bfloat16")
    cfg = reduce_config(get_config("hymba-1.5b")).replace(dtype="bfloat16")
    jparams = jax.jit(JaxLM(jcfg).init)(jax.random.key(1))
    params = convert.lm_params_from_numpy(
        cfg, jax.tree.map(np.asarray, jparams), device="cpu")
    return jcfg, jparams, cfg, params


# attn_block at bf16, port vs JAX: max|port - jax| / max|jax| measured
# 4.4e-4 with 0.09 % of the elements differing (global layer) and 0 (SWA
# layer). The two frameworks may round the bf16 projections differently, so
# the gate is one bf16 ulp of the largest value (2^-8 relative) and 1 % of
# the elements
RTOL_BLOCK_BF16 = 2.0 ** -8
MAX_SHARE_BLOCK_BF16 = 0.01


@pytest.mark.parametrize("seg,window", [("full0", None), ("swa0", 16)])
def test_attn_block_bf16_matches_the_jax_model(bf16_models, seg, window):
    """One global and one sliding-window layer of the reduced hymba at
    bf16, S = 4 meta + 40 text positions (the window cuts)."""
    jcfg, jparams, cfg, params = bf16_models
    sink = cfg.meta_tokens if window is not None else 0
    S = cfg.meta_tokens + 40
    x = np.random.default_rng(7).normal(size=(2, S, cfg.d_model)).astype(
        np.float32)
    jp = {k: v[0] for k, v in jparams[seg]["attn"].items()}
    jout, (jk, _) = jax_attn.attn_block(jp, jnp.asarray(x, jnp.bfloat16),
                                        jcfg, jnp.arange(S), window=window,
                                        sink=sink)
    p = {k: v[0] for k, v in params[seg]["attn"].items()}
    out, (k, _) = attn.attn_block(p, torch.from_numpy(x).bfloat16(), cfg,
                                  torch.arange(S), window=window, sink=sink)
    got, want = out.float().numpy(), np.asarray(jout.astype(jnp.float32))
    gap = np.abs(got - want)
    assert gap.max() <= RTOL_BLOCK_BF16 * np.abs(want).max()
    assert (gap > 0).mean() <= MAX_SHARE_BLOCK_BF16


def test_wrapper_runs_the_plain_version_on_the_cpu():
    q, k, v = (torch.from_numpy(a) for a in _inputs((2, 6, 70, 32),
                                                    (2, 3, 70, 32), 3))
    before = kflash.flash_attention.launches
    got = kflash.flash_attention(q, k, v, causal=True)
    assert torch.equal(got, ref.attention_ref(q, k, v, causal=True))
    assert kflash.flash_attention.launches == before


def test_wrapper_rejects_what_the_kernel_does_not_take():
    q = torch.ones((1, 4, 8, 16))
    kv = torch.ones((1, 2, 8, 16))
    with pytest.raises(TypeError):
        kflash.flash_attention(q.double(), kv.double(), kv.double())
    with pytest.raises(TypeError):
        kflash.flash_attention(q, kv.bfloat16(), kv)
    with pytest.raises(ValueError):     # H not a multiple of K
        kflash.flash_attention(q, torch.ones((1, 3, 8, 16)),
                               torch.ones((1, 3, 8, 16)))
    with pytest.raises(ValueError):     # head dims differ
        kflash.flash_attention(q, torch.ones((1, 2, 8, 8)),
                               torch.ones((1, 2, 8, 8)))
    with pytest.raises(ValueError):
        kflash.flash_attention(q.transpose(2, 3), kv, kv)
    with pytest.raises(ValueError):     # a window needs causal masking
        kflash.flash_attention(q, kv, kv, causal=False, window=4)
    with pytest.raises(ValueError):     # ... and as many keys as queries
        kflash.flash_attention(q, kv[:, :, :6].contiguous(),
                               kv[:, :, :6].contiguous(), window=4)
    with pytest.raises(ValueError):
        kflash.flash_attention(q, kv, kv, window=0)
    with pytest.raises(ValueError):
        kflash.flash_attention(q, kv, kv, window=4, sink=-1)
    # neither the CPU nor a CUDA device: no plain-version fallback
    with pytest.raises(ValueError, match="cuda or cpu"):
        kflash.flash_attention(q.to("meta"), kv.to("meta"), kv.to("meta"))


# ---------------------------------------------------------------------------
# gradients: the wrapper on the CPU (its plain version under autograd)
# against jax.grad of the JAX model's attention
# ---------------------------------------------------------------------------

# max|port - jax| / max|jax| per gradient, float32; measured worst 6.7e-7
RTOL_GRAD = 5e-6
# (B, S, K, G, hd, window, sink, chunk): GQA; a ragged S; a window with a
# sink no tile boundary meets; the reduced hymba's window 16 with 4 meta
# tokens; the JAX model's blocking over several q chunks (S % chunk == 0)
GRAD_CASES = [(2, 64, 2, 3, 16, None, 0, 2048), (1, 77, 1, 4, 32, None, 0,
                                                 2048),
              (1, 130, 2, 2, 16, 40, 6, 2048), (2, 44, 2, 2, 16, 16, 4,
                                                2048),
              (1, 96, 2, 2, 16, 24, 4, 32)]


def attention_grad_gaps(case, seed=7):
    """[dq, dk, dv] relative gaps: ``models.attention.causal_attention``
    (the wrapper, plain route) against jax.grad of the JAX model's, for the
    loss sum(o * w) with w drawn from ``seed``."""
    B, S, K, G, hd, window, sink, chunk = case
    q, k, v = _model_inputs(B, S, K, G, hd, seed)
    w = np.random.default_rng(seed + 1).normal(
        size=(B, S, K * G, hd)).astype(np.float32)

    def jax_loss(q, k, v):
        o = jax_attn.causal_attention(q, k, v, jnp.arange(S), window=window,
                                      chunk=chunk, sink=sink)
        return jnp.sum(o * w)
    want = jax.grad(jax_loss, argnums=(0, 1, 2))(
        *(jnp.asarray(a) for a in (q, k, v)))
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    o = attn.causal_attention(*leaves, torch.arange(S), window=window,
                              sink=sink)
    got = torch.autograd.grad((o * torch.from_numpy(w)).sum(), leaves)
    return [float(np.abs(g.numpy() - np.asarray(j)).max()
                  / np.abs(np.asarray(j)).max()) for g, j in zip(got, want)]


@pytest.mark.parametrize("case", GRAD_CASES, ids=str)
def test_wrapper_gradients_match_jax_grad_of_the_model_attention(case):
    assert max(attention_grad_gaps(case)) <= RTOL_GRAD


def _global_layer_gaps():
    """(ulps, share) of the global-layer check above, and of the same
    layer with p rounded to bf16 as before the repair."""
    S = 256
    cfg, p, x = _hymba_heads_layer(S)
    q, k, v = attn._qkv(p, x, cfg, torch.arange(S))
    want = _jax_model_attention(*(t.float().numpy() for t in (q, k, v)),
                                "bf16", None, 0)
    B, S, K, G, hd = q.shape
    heads = (q.reshape(B, S, K * G, hd).transpose(1, 2).contiguous(),
             k.transpose(1, 2).contiguous(), v.transpose(1, 2).contiguous())
    return {round_p: bf16_ulp_gaps(
        ref.attention_ref(*heads, round_p=round_p).transpose(1, 2)
        .float().numpy(), want) for round_p in (False, True)}


# ---------------------------------------------------------------------------
# the backward kernel's work split (kernels/csrc/flash_attention_bwd.cu)
# ---------------------------------------------------------------------------

_CSRC = Path(__file__).resolve().parents[1] / "src/repro_torch/kernels/csrc"


def _cuh_int(name):
    """A ``constexpr int`` of ``flash_attention.cuh``, read from the source
    the kernels are built from."""
    text = (_CSRC / "flash_attention.cuh").read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))


BQ, BK = _cuh_int("kBQ"), _cuh_int("kBK")   # q rows, keys a tile
BQWG = _cuh_int("kBQWG")   # q rows a block of the wgmma forward


def _tiles_of(S, Sk, window, sink, q0, rows=BQ):
    """flash_attention.cuh ``tiles_of<rows>`` (causal): (n_sink, first, n)
    of the kv tiles the forward's walk of the q tile of ``rows`` rows from
    row q0 visits."""
    hi = min(-(-Sk // BK) - 1, (min(q0 + rows, S) - 1) // BK)
    first = n_sink = 0
    if window:
        first = max(0, q0 - window + 1) // BK
        n_sink = min(-(-sink // BK), first)
    return n_sink, first, n_sink + max(hi - first + 1, 0)


def _walk(tiles):
    """``Tiles::operator[]`` over i < n: the tiles in the walk's order."""
    n_sink, first, n = tiles
    return [i if i < n_sink else first + (i - n_sink) for i in range(n)]


def _visits(tiles, t):
    """``Tiles::visits``: whether kv tile t is in the walk."""
    n_sink, first, n = tiles
    return t < n_sink or first <= t < first + (n - n_sink)


def _bwd_split(B, H, S, window, sink):
    """The blocks of the backward's dK/dV and dQ kernels in launch order
    (the grid's x axis, b * H + h, fastest), each with the (head, q tile,
    kv tile) pairs it takes, as ``flash_attention_bwd.cu`` forms them:
    dK/dV one block per (head, key tile ``blockIdx.y``) over the q tiles
    ``KvBlock::next`` yields (``Tiles::visits``); dQ one block per (head,
    ``QBlock`` q tile ``n_qt - 1 - blockIdx.y``) over its walk
    (``Tiles::operator[]``)."""
    n_qt, n_kt = -(-S // BQ), -(-S // BK)
    tiles = [_tiles_of(S, S, window, sink, qt * BQ) for qt in range(n_qt)]
    dkdv = [[(bh, qt, t) for qt in range(n_qt) if _visits(tiles[qt], t)]
            for t in range(n_kt) for bh in range(B * H)]
    dq = [[(bh, n_qt - 1 - row, t) for t in _walk(tiles[n_qt - 1 - row])]
          for row in range(n_qt) for bh in range(B * H)]
    return tiles, dkdv, dq


def _visible_tile_pairs(S, window, sink, rows=BQ):
    """(q tile, kv tile) pairs, q tiles of ``rows`` rows, holding a (row,
    key) the mask leaves visible: key c visible to row r when c <= r and
    (no window, r - c < window or c < sink)."""
    r, c = np.arange(S)[:, None], np.arange(S)[None, :]
    vis = c <= r
    if window is not None:
        vis &= (r - c < window) | (c < sink)
    n_qt, n_kt = -(-S // rows), -(-S // BK)
    pad = np.zeros((n_qt * rows, n_kt * BK), bool)
    pad[:S, :S] = vis
    any_ = pad.reshape(n_qt, rows, n_kt, BK).any(axis=(1, 3))
    return {(int(qt), int(t)) for qt, t in zip(*np.nonzero(any_))}


def _attn_bwd_cases():
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke
    return chip_smoke.ATTN_BWD_CASES


def _walk_cases():
    """(S, window, sink) of chip_smoke.py's ATTN_BWD_CASES and
    ATTN_MASK_CASES (causal)."""
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke
    return ([(c[3], c[5], c[6]) for c in chip_smoke.ATTN_BWD_CASES]
            + [(c[3], c[5], c[6]) for c in chip_smoke.ATTN_MASK_CASES])


@pytest.mark.parametrize("case", _walk_cases(), ids=str)
def test_forward_walk_of_a_128_row_q_tile_visits_each_visible_pair_once(
        case):
    """The wgmma forward's walk (``tiles_of<kBQWG>``, the row count read
    from the header) visits every (q tile, kv tile) pair of its 128-row q
    tiles that holds a visible score exactly once and no other, and is the
    union of the walks of its two 64-row halves (the tiles its
    warpgroups' rows see); the 64-row walk (``tiles_of``'s default, the
    mma.sync kernels' and the backward's) still visits exactly the visible
    pairs of its 64-row q tiles."""
    S, window, sink = case
    text = (_CSRC / "flash_attention.cuh").read_text()
    assert "template <int kRows = kBQ>" in text
    assert "(min(q0 + kRows, S) - 1) / kBK" in text
    for rows in (BQ, BQWG):
        walks = [_walk(_tiles_of(S, S, window, sink, qt * rows, rows))
                 for qt in range(-(-S // rows))]
        assert all(len(set(w)) == len(w) for w in walks)
        assert {(qt, t) for qt, w in enumerate(walks) for t in w} \
            == _visible_tile_pairs(S, window, sink, rows)
    for qt in range(-(-S // BQWG)):
        halves = {t for q0 in (qt * BQWG, qt * BQWG + BQ) if q0 < S
                  for t in _walk(_tiles_of(S, S, window, sink, q0))}
        assert set(_walk(_tiles_of(S, S, window, sink, qt * BQWG, BQWG))) \
            == halves


@pytest.mark.parametrize("case", _attn_bwd_cases(), ids=str)
def test_backward_work_split_takes_each_visited_tile_pair_once(case):
    """The forward's walk (``Tiles::operator[]``) visits exactly the tile
    pairs the mask leaves a visible score in, each once; the dK/dV blocks
    (``KvBlock::next`` through ``Tiles::visits``) and the dQ blocks each take
    every such (head, q tile, kv tile) pair exactly once and no other; no
    dK/dV block takes more than the S / 64 q tiles of one head (the first
    port's block took G heads' worth, up to 90 at hymba's shape), and they
    start longest first. The tile sizes are read from the kernel's header;
    the grid's formulas are restated from ``flash_attention_bwd.cu``."""
    B, H, K, S, D, window, sink, _ = case
    tiles, dkdv, dq = _bwd_split(B, H, S, window, sink)
    walks = [_walk(t) for t in tiles]
    assert all(len(set(w)) == len(w) for w in walks)
    assert {(qt, t) for qt, w in enumerate(walks) for t in w} \
        == _visible_tile_pairs(S, window, sink)
    visited = Counter((bh, qt, t) for bh in range(B * H)
                      for qt, walk in enumerate(walks) for t in walk)
    for blocks in (dkdv, dq):
        taken = Counter(pair for block in blocks for pair in block)
        assert taken == visited
    items = [len(block) for block in dkdv]
    assert max(items) <= len(walks)
    assert items == sorted(items, reverse=True)



@pytest.mark.parametrize("dims,dtype,pair", [
    ((128, 128), torch.bfloat16, "wg2"), ((192, 128), torch.bfloat16, "wg2"),
    ((64, 64), torch.bfloat16, "wg"), ((96, 96), torch.bfloat16, "wg2"),
    ((32, 32), torch.bfloat16, "tc"), ((16, 16), torch.bfloat16, "tc"),
    ((24, 16), torch.bfloat16, "tc"), ((100, 128), torch.bfloat16, "wg2"),
    ((80, 96), torch.bfloat16, "wg2"), ((96, 96), torch.float32, "f32"),
    ((128, 128), torch.float32, "f32"), ((64, 64), torch.float32, "f32")],
    ids=str)
def test_backward_kernel_names_the_pair_the_launch_runs(dims, dtype, pair):
    """``backward_kernel`` names the (dK/dV, dQ) pair the library's
    ``launch`` routes (D, Dv) to after the wrapper pads q and k to
    ``kernel_dim``: bf16 at (96, 96), (128, 128) and (192, 128) the
    two-warpgroup wgmma kernels (``constexpr bool kWG2 = wg2_pair(D, DV)``
    in ``flash_attention_bwd.cu``, its one ``return`` read from the source
    and evaluated), at D = 64 the one-warpgroup ones, mma.sync at the
    reduced configs' bf16 pairs, the float32 pair for float32; and
    ``WGMMA_PAIRS`` is exactly the pairs ``wg2_pair`` takes."""
    text = (_CSRC / "flash_attention_bwd.cu").read_text()
    assert "constexpr bool kWG2 = wg2_pair(D, DV);" in text
    assert "if constexpr (D == 64 && DV == 64) {" in text
    assert kflash.backward_kernel(*dims, dtype) == (
        f"dkdv_kernel_{pair}", f"dq_kernel_{pair}")
    padded = (kflash.kernel_dim(*dims), dims[1])
    assert _cu_wg2_pair(*padded) == (pair == "wg2" or (
        dtype == torch.float32 and padded in kflash.WGMMA_PAIRS))
    assert set(kflash.WGMMA_PAIRS) == {
        pr for pr in kflash.HEAD_DIM_PAIRS if _cu_wg2_pair(*pr)}


def _cu_wg2_pair(D, Dv):
    """``wg2_pair(D, Dv)`` of ``flash_attention_bwd.cu``: its one
    ``return`` expression read from the source and evaluated with C's
    operators."""
    text = (_CSRC / "flash_attention_bwd.cu").read_text()
    body = re.search(r"constexpr bool wg2_pair\(int D, int Dv\) \{\s*"
                     r"return (.*?);\s*\}", text, re.S).group(1)
    expr = re.sub(r"\s+", " ", body).replace("&&", " and ").replace(
        "||", " or ")
    return bool(eval(expr, {}, {"D": D, "Dv": Dv}))


def _scratch_floats(B, H, K, S, D, Dv):
    """``scratch_of(...).floats()`` of ``flash_attention_bwd.cu`` for bf16
    (self-attention, Sk = S), restated from its formulas (asserted in the
    source's text): Delta, then fp32 dK / dV partials of every query head
    where the launch is not the two-warpgroup pair with a block taking
    the kv head's G heads."""
    text = (_CSRC / "flash_attention_bwd.cu").read_text()
    for formula in (
            "bf16_in && !(wg2_pair(D, Dv) && wg2_heads(B, K, Sk, G) == G);",
            "const long long rows = partials ? static_cast<long long>(B) * H "
            "* Sk : 0;",
            "long long part_at() const { return (delta + 3) & ~3LL; }",
            "long long floats() const { return part_at() + part_k + part_v; }",
            "return Scratch{static_cast<long long>(B) * H * S, rows * D, "
            "rows * Dv};"):
        assert formula in text, formula
    G = H // K
    heads = G if B * K * -(-S // BK) >= _bwd_int("kSumHeadsBlocks") else 1
    partials = not (_cu_wg2_pair(D, Dv) and heads == G)
    rows = B * H * S if partials else 0
    return -(-B * H * S // 4) * 4 + rows * (D + Dv)


@pytest.mark.parametrize("case", [
    ((4, 32, 32, 1128, 96), 1, False), ((1, 8, 2, 1128, 96), 1, True),
    ((4, 16, 8, 1128, 96), 2, False), ((2, 4, 2, 300, 96), 1, True),
    ((4, 16, 8, 1128, 128), 2, False), ((1, 48, 1, 1128, 128), 1, True),
    ((4, 16, 16, 1128, 128), 1, False)], ids=str)
def test_backward_scratch_holds_partials_only_where_a_block_takes_one_head(
        case):
    """At (96, 96) as at (128, 128): ``backward_heads_per_block`` is 1 at
    phi-3-vision-4.2b's training shape (one query head a kv head: the
    dK/dV blocks store dk and dv themselves) and at GQA shapes under
    ``SUM_HEADS_BLOCKS`` dK/dV blocks, the kv head's G above it; the
    launch's scratch holds the per-head fp32 partials (B H S (D + Dv)
    floats past Delta) only where a block takes one head of several."""
    (B, H, K, S, D), nh, partials = case
    assert kflash.backward_heads_per_block(B, H, K, S, D, D,
                                           torch.bfloat16) == nh
    delta = -(-B * H * S // 4) * 4
    assert _scratch_floats(B, H, K, S, D, D) == delta + (
        B * H * S * 2 * D if partials else 0)


@pytest.mark.parametrize("case", [
    ((4, 16, 8, 1128), 2), ((4, 64, 8, 1128), 8), ((4, 48, 1, 1128), 1),
    ((4, 16, 16, 1128), 1), ((1, 32, 8, 333), 1), ((8, 8, 4, 1000), 2),
    ((8, 8, 4, 1024), 2), ((8, 8, 4, 960), 1)], ids=str)
def test_backward_heads_per_block_follows_the_launch(case):
    """``backward_heads_per_block`` restates ``launch``'s choice (the
    kv head's G query heads a dK/dV block where B K ceil(Sk / 64) >=
    kSumHeadsBlocks, read from the source, else one) at (128, 128) and (96,
    96) bf16, and is 1 on the other pairs and in float32."""
    (B, H, K, S), nh = case
    assert kflash.SUM_HEADS_BLOCKS == _bwd_int("kSumHeadsBlocks")
    for D in (128, 96):
        assert kflash.backward_heads_per_block(B, H, K, S, D, D,
                                               torch.bfloat16) == nh
    for D, dtype in ((64, torch.bfloat16), (96, torch.float32),
                     (128, torch.float32)):
        assert kflash.backward_heads_per_block(B, H, K, S, D, D, dtype) == 1

def _bwd_int(name):
    """A ``constexpr`` integer of ``flash_attention_bwd.cu`` (``int`` or
    ``long long``, a literal or ``a << b``)."""
    text = (_CSRC / "flash_attention_bwd.cu").read_text()
    m = re.search(rf"constexpr (?:int|long long) {name} = (\d+)(?:LL)?"
                  rf"(?: << (\d+))?;", text)
    return int(m.group(1)) << int(m.group(2) or 0)


def _warpgroup_threads():
    """The threads of a warpgroup, from the header's ``kThreadsTC = 32 *
    kWarps``."""
    assert "constexpr int kThreadsTC = 32 * kWarps;" in \
        (_CSRC / "flash_attention.cuh").read_text()
    return 32 * _cuh_int("kWarps")


def _wg2_split(B, H, K, S, D, window, sink):
    """The one-dimensional grids of ``dkdv_kernel_wg2`` and
    ``dq_kernel_wg2`` as ``flash_attention_bwd.cu``'s ``launch`` sets them
    up, restated. dK/dV: a block takes nh query heads, the kv head's G
    where B K n_kt >= kSumHeadsBlocks, else one; block b of the n_units =
    B H / nh units by n_kt key tiles is (unit b % n_units, key tile b /
    n_units) where nh > 1 or the heads' Q and dO (B H S 2 D bf16) fit in
    kL2Bytes, else (b / n_kt, b % n_kt); it walks items g << 16 | qt (head
    unit nh + g, q tile qt), heads in turn, whose q tile visits its key
    tile (``KvBlock::next_item``). dQ block b < n_q_blocks is ``QBlock(H, K, b %
    n_qt, n_qt, b / n_qt)``: head b / n_qt, q tile n_qt - 1 - b % n_qt,
    over its walk. Where nh < G, ``rows(1)`` combine blocks follow, thread
    t < kThreadsTC of block c taking float4 (c kIters + r) kThreadsTC + t of
    dK and of dV for r < kIters (``Combine::slice``), below n4 = B K S D /
    4. Returns (nh, tile_slow, the dK/dV blocks' (head, q tile,
    key tile) lists, the dQ blocks', the combine blocks' float4 index
    arrays, n4)."""
    n_qt, n_kt = -(-S // BQ), -(-S // BK)
    tiles = [_tiles_of(S, S, window, sink, qt * BQ) for qt in range(n_qt)]
    G = H // K
    nh = G if B * K * n_kt >= _bwd_int("kSumHeadsBlocks") else 1
    tile_slow = nh > 1 or B * H * S * 2 * D * 2 <= _bwd_int("kL2Bytes")
    n_units = B * H // nh
    dkdv = []
    for b in range(n_kt * n_units):
        unit, t = (b % n_units, b // n_units) if tile_slow \
            else (b // n_kt, b % n_kt)
        dkdv.append([(unit * nh + g, qt, t) for g in range(nh)
                     for qt in range(n_qt) if _visits(tiles[qt], t)])
    n_q_blocks = n_qt * B * H
    dq = []
    for b in range(n_q_blocks):
        qt = n_qt - 1 - b % n_qt
        dq.append([(b // n_qt, qt, t) for t in _walk(tiles[qt])])
    kiters, nt = _bwd_int("kIters"), _warpgroup_threads()
    n4 = B * K * S * D // 4
    n_combine = 0 if nh == G else -(-n4 // (kiters * nt))
    idx = np.arange(kiters)[:, None] * nt + np.arange(nt)[None, :]
    combine = [(c * kiters * nt + idx).ravel() for c in range(n_combine)]
    combine = [i[i < n4] for i in combine]
    return nh, tile_slow, dkdv, dq, combine, n4


def _dense_split_cases():
    """(B, H, K, S, D, window, sink): the dense family's training shapes on
    phase 40's batch (internlm2-1.8b 16 / 8, qwen3-8b 32 / 8, qwen3-32b 64 /
    8: a block sums its kv head's heads; granite-34b's MQA 48 / 1: a block
    a head, and the combine; moonshot's 16 / 16 heads of 128), a ragged S
    of qwen3-8b's heads, and chip_smoke.py's ATTN_BWD_CASES."""
    return ([(4, h, k, 1128, 128, None, 0)
             for h, k in ((16, 8), (32, 8), (64, 8), (48, 1), (16, 16))]
            + [(1, 32, 8, 333, 128, None, 0)]
            + [c[:7] for c in _attn_bwd_cases()])


@pytest.mark.parametrize("case", _dense_split_cases(), ids=str)
def test_wg2_backward_grid_takes_each_pair_and_float4_once(case):
    """The two-warpgroup backward's one-dimensional grids (the formulas
    asserted in ``flash_attention_bwd.cu``'s text; the tile sizes, the
    warpgroup's threads, kIters, kSumHeadsBlocks and kL2Bytes read from its
    sources):
    the dK/dV blocks and the dQ blocks each take every visited (head, q
    tile, kv tile) exactly once and no other; a dK/dV block's heads share
    one kv head and its items come in (head, q tile) order (the order its
    sums take them in); with the key tile as the slow axis the blocks of
    the first key tiles come first, else a unit's blocks are adjacent, as
    a head's dQ blocks are; where a block takes one of G > 1 heads the
    combine blocks' slices cover dK's and dV's float4s exactly once, each
    summing the G query heads of its kv head in head order (the heads whose
    dK/dV blocks wrote it: ``KvBlock``'s kv head of each); where it takes
    all G the dQ launch has no combine block."""
    B, H, K, S, D, window, sink = case
    text = (_CSRC / "flash_attention_bwd.cu").read_text()
    for formula in (
            "const int G = H / K, nh = wg2_heads(B, K, mk.Sk, G);",
            "return static_cast<long long>(B) * K * n_kt >= kSumHeadsBlocks ? "
            "G : 1;",
            "nh > 1 || rows * (D + DV) * static_cast<long long>(sizeof(bf16)) "
            "<=\n                    kL2Bytes;",
            "const int n_kt = (mk.Sk + kBK - 1) / kBK, n_units = gridDim.x / "
            "n_kt;",
            "const int unit = tile_slow ? blockIdx.x % n_units : blockIdx.x / "
            "n_kt;",
            "const int tile = tile_slow ? blockIdx.x / n_units : blockIdx.x % "
            "n_kt;",
            "const KvBlock blk(H, K, S, unit * nh, tile);",
            "static_cast<long long>(blk.bh + (it >> 16)) * S;",
            "for (int g = it >> 16, qt = it & 0xFFFF; g < nh; ++g, qt = 0)",
            "if (tiles_of(mk, qt * kBQ, S).visits(t_kv)) return g << 16 | qt;",
            "QBlock blk(H, K, blockIdx.x % n_qt, n_qt, blockIdx.x / n_qt);",
            "const long long i = (blk * kIters + r) * kThreadsTC + "
            "threadIdx.x;",
            "if (threadIdx.x < kThreadsTC) cb.slice(blockIdx.x - n_q_blocks);",
            "const int n_combine = nh == G ? 0 : cb.rows(1);",
            "const long long h0 = (bkv / K) * H + (bkv % K) * G;",
            "kvh = (bh / H) * K + (bh % H) / (H / K);"):
        assert formula in text, formula
    nh, tile_slow, dkdv, dq, combine, n4 = _wg2_split(B, H, K, S, D, window,
                                                       sink)
    G = H // K
    n_qt = -(-S // BQ)
    tiles = [_tiles_of(S, S, window, sink, qt * BQ) for qt in range(n_qt)]
    visited = Counter((bh, qt, t) for bh in range(B * H)
                      for qt in range(n_qt) for t in _walk(tiles[qt]))
    for blocks in (dkdv, dq):
        assert Counter(p for block in blocks for p in block) == visited
    for block in dkdv:
        assert len({(bh // H) * K + (bh % H) // G for bh, _, _ in block}) <= 1
        assert block == sorted(block)
    firsts = [(block[0][0], block[0][2]) for block in dkdv if block]
    if tile_slow:
        assert [t for _, t in firsts] == sorted(t for _, t in firsts)
    else:
        assert [bh for bh, _ in firsts] == sorted(bh for bh, _ in firsts)
    heads = [block[0][0] for block in dq if block]
    assert heads == sorted(heads)
    if nh == G:
        assert combine == []
        return
    taken = np.concatenate(combine)
    assert np.array_equal(np.sort(taken), np.arange(n4))
    # the heads each float4 sums: kv head bkv = (4 i) / (S D), query heads
    # h0 .. h0 + G - 1 in that order, h0 = (bkv / K) H + (bkv % K) G; the
    # dK/dV blocks of exactly those heads map to kv head bkv
    bkv = (4 * taken) // (S * D)
    h0 = (bkv // K) * H + (bkv % K) * G
    for g in range(G):
        bh = h0 + g
        assert np.array_equal((bh // H) * K + (bh % H) // G, bkv)
    writers = Counter(((bh // H) * K + (bh % H) // G) for bh in range(B * H))
    assert set(writers.values()) == {G} and len(writers) == B * K


# ---------------------------------------------------------------------------
# the wgmma forward's routes and its 64-byte-swizzled slabs (csrc/wgmma.cuh)
# ---------------------------------------------------------------------------

def _cu_bool_fn(name, D, DV):
    """The value of ``constexpr bool name<D, DV>()`` of
    ``flash_attention.cu`` at (D, DV): its one ``return`` expression,
    read from the source and evaluated with C's operators."""
    text = (_CSRC / "flash_attention.cu").read_text()
    body = re.search(rf"constexpr bool {name}\(\) \{{\s*return (.*?);\s*\}}",
                     text, re.S).group(1)
    expr = re.sub(r"\s+", " ", body).replace("&&", " and ").replace(
        "||", " or ")
    return bool(eval(expr, {}, {"D": D, "DV": DV}))


@pytest.mark.parametrize("dims,dtype,fwd,bwd", [
    ((64, 64), torch.bfloat16, "wg", "wg"),
    ((96, 96), torch.bfloat16, "wg", "wg2"),
    ((128, 128), torch.bfloat16, "wg", "wg2"),
    ((192, 128), torch.bfloat16, "wg", "wg2"),
    ((16, 16), torch.bfloat16, "tc", "tc"),
    ((32, 32), torch.bfloat16, "tc", "tc"),
    ((32, 16), torch.bfloat16, "tc", "tc"),
    ((24, 16), torch.bfloat16, "tc", "tc"),
    ((96, 96), torch.float32, "f32", "f32"),
    ((64, 64), torch.float32, "f32", "f32"),
    ((128, 128), torch.float32, "f32", "f32")], ids=str)
def test_forward_kernel_names_the_kernel_the_launch_runs(dims, dtype, fwd,
                                                         bwd):
    """``forward_kernel`` names the kernel the library's ``launch`` routes
    (D, Dv) to after the wrapper pads q and k to ``kernel_dim``: bf16 at
    (64, 64), (96, 96), (128, 128) and (192, 128) ``flash_kernel_wg``
    (where ``wgmma_forward<D, DV>()``, read from the source, holds), at
    the other bf16 pairs (24 padded to 32) ``flash_kernel_tc``, float32
    ``flash_kernel_f32``; and the backward's routes: ``wg`` at 64, ``wg2``
    at 96, (128, 128) and (192, 128), ``tc`` at the reduced pairs."""
    D, Dv = dims
    assert kflash.forward_kernel(D, Dv, dtype) == f"flash_kernel_{fwd}"
    assert kflash.backward_kernel(D, Dv, dtype) == (
        f"dkdv_kernel_{bwd}", f"dq_kernel_{bwd}")
    pair = (kflash.kernel_dim(D, Dv), Dv)
    assert _cu_bool_fn("wgmma_forward", *pair) == (
        pair in kflash.WGMMA_FWD_PAIRS)
    assert set(kflash.WGMMA_FWD_PAIRS) == {
        pr for pr in kflash.HEAD_DIM_PAIRS if _cu_bool_fn("wgmma_forward",
                                                          *pr)}


def _cuh_fn(name):
    """``name(r, c)`` of ``wgmma.cuh`` (``sw64``, ``sw128``), its return
    expression read from the source and evaluated in Python (the same
    operators, with the same precedence, as C's)."""
    text = (_CSRC / "wgmma.cuh").read_text()
    expr = re.search(rf"uint32_t {name}\(int r, int c\) \{{\s*return (.*?);",
                     text, re.S).group(1)
    return lambda r, c: eval(expr, {}, {"r": r, "c": c})


def _swizzle(addr, bits):
    """CUTLASS's ``Swizzle<bits, 4, 3>`` of a byte address: address bits
    [4, 4 + bits) XOR bits [7, 7 + bits)."""
    mask = ((1 << bits) - 1) << 7
    return addr ^ ((addr & mask) >> 3)


# (slab columns W, the swizzle's bits, its byte offset's name in wgmma.cuh)
SWIZZLES = [(32, 2, "sw64"), (64, 3, "sw128")]


@pytest.mark.parametrize("W,bits,name", SWIZZLES, ids=str)
def test_slab_swizzle_is_cutlass_and_a_bijection_of_each_row_group(W, bits,
                                                                   name):
    """A slab of W columns (rows of 2 W bytes): ``sw64`` / ``sw128`` place
    16-byte chunk c of row r where CUTLASS's ``Swizzle<bits, 4, 3>`` of the
    linear layout the wgmma descriptor describes (rows 2 W bytes apart,
    8-row groups 16 W bytes apart: the SBO ``desc_sw64`` / ``desc_sw128``
    set) puts it; within each 8-row group the map is a bijection onto the
    group's 16-byte chunks; and the 8 rows a core matrix (or an ldmatrix)
    reads at one chunk lie in 8 distinct 16-byte bank groups."""
    at = _cuh_fn(name)
    text = (_CSRC / "wgmma.cuh").read_text()
    desc = re.search(rf"uint64_t desc_{name}\(uint32_t addr\) \{{(.*?)\}}",
                     text, re.S).group(1)
    assert f"static_cast<uint64_t>({16 * W} >> 4) << 32" in desc   # SBO
    mode = {32: 2, 64: 1}[W]                 # bits 62-63: 64 / 128 bytes
    assert f"static_cast<uint64_t>({mode}) << 62" in desc
    chunks = W // 8
    for r in range(64):
        for c in range(chunks):
            assert at(r, c) == _swizzle(r * 2 * W + 16 * c, bits)
    for g in range(8):
        offs = sorted(at(r, c) for r in range(8 * g, 8 * g + 8)
                      for c in range(chunks))
        assert offs == list(range(g * 16 * W, (g + 1) * 16 * W, 16))
        for c in range(chunks):
            groups = {(at(r, c) % 128) // 16 for r in range(8 * g, 8 * g + 8)}
            assert len(groups) == 8


def _load_rows(W, NS, NT, kCols, row0, n_rows):
    """``load_rows<W, NS, NT, kCols>`` (the formulas asserted in
    ``wgmma.cuh``'s text): a thread's chunk c of row r of every slab, i =
    tid + m NT, r = i / (W / 8), c = i % (W / 8), by shifts. For each
    thread and step, (shared byte offset, source row, source column, bytes,
    row, chunk of the row), in issue order."""
    text = (_CSRC / "wgmma.cuh").read_text()
    for formula in (
            "constexpr int kChunks = W / 8, kShift = W == 64 ? 3 : 2;",
            "static_assert(kCols == NS * W, \"whole rows of NS slabs\");",
            "for (int m = 0; m < 64 * kChunks / NT; ++m) {",
            "const int i = tid + m * NT, r = i >> kShift, c = i & (kChunks - "
            "1);",
            "src + static_cast<long long>(in ? row0 + r : 0) * kCols + 8 * c;",
            "const uint32_t at = dst + slab_at<W>(r, c);",
            "cp_async16(at + s * slab_bytes<W>(), row + W * s, in ? 16 : 0);",
            "return 64 * 2 * W;",
            "return W == 64 ? sw128(r, c) : sw64(r, c);"):
        assert formula in text, formula
    assert kCols == NS * W
    at = _cuh_fn("sw64" if W == 32 else "sw128")
    k_chunks, shift = W // 8, {64: 3, 32: 2}[W]
    assert 1 << shift == k_chunks
    slab = 64 * 2 * W
    out = []
    for tid in range(NT):
        for m in range(64 * k_chunks // NT):
            i = tid + m * NT
            r, c = i >> shift, i & (k_chunks - 1)
            inside = row0 + r < n_rows
            for s_ in range(NS):
                cc = s_ * k_chunks + c
                out.append((s_ * slab + at(r, c),
                            row0 + r if inside else 0,
                            8 * cc if inside else 0,
                            16 if inside else 0, r, cc))
    return out


def _check_load_rows(W, NS, kCols, row0, n_rows):
    """Every (row, 16-byte chunk) of the 64-row tile is written exactly
    once, at ``slab_at``'s offset in slab chunk / (W / 8), so that the
    slabs' bytes are covered exactly once; a chunk of a real row reads that
    row's 16 bytes at column 8 chunk, any other is zero-filled (0 source
    bytes from row 0, column 0: an address inside the tensor); neighbouring
    threads take neighbouring chunks of a slab's row. By a warpgroup's 128
    threads (the forward's producer; the backward's streaming warpgroup)
    and a block's 256 (the backward's first tiles)."""
    for NT in (128, 256):
        writes = _load_rows(W, NS, NT, kCols, row0, n_rows)
        assert Counter((r, cc) for *_, r, cc in writes) == Counter(
            (r, cc) for r in range(64) for cc in range(NS * W // 8))
        assert sorted(off for off, *_ in writes) == list(
            range(0, NS * 64 * 2 * W, 16))
        for off, src_row, src_col, nbytes, r, cc in writes:
            real = row0 + r < n_rows
            assert nbytes == (16 if real else 0)
            assert (src_row, src_col) == ((row0 + r, 8 * cc) if real
                                          else (0, 0))
        first = [(r, cc) for *_, r, cc in writes[::len(writes) // NT]]
        assert first == [divmod(tid, W // 8) for tid in range(NT)]


# (W, NS, kCols, row0, n_rows): q, k and v at D = 96 (three 32-column
# slabs), a ragged last tile of them (S = 1,000: rows 960..999 real) and
# one row
LOAD_CASES = [(32, 3, 96, 0, 1000), (32, 3, 96, 960, 1000),
              (32, 3, 96, 0, 1)]


@pytest.mark.parametrize("case", LOAD_CASES, ids=str)
def test_96_column_loader_writes_every_row_chunk_once(case):
    """``load_rows`` at 96 columns (``_check_load_rows``)."""
    _check_load_rows(*case)


# the same at 64 and 128 columns (one and two 64-column slabs in the
# 128-byte swizzle): whole tiles, a ragged last one and one row
LOAD_CASES_64 = [(64, 1, 64, 0, 1000), (64, 1, 64, 960, 1000),
                 (64, 2, 128, 0, 1000), (64, 2, 128, 960, 1000),
                 (64, 2, 128, 0, 1)]


@pytest.mark.parametrize("case", LOAD_CASES_64, ids=str)
def test_64_column_slab_loader_writes_every_row_chunk_once(case):
    """``load_rows`` at 64-column slabs (``_check_load_rows``)."""
    _check_load_rows(*case)


def test_96_column_products_read_the_slabs_as_loaded():
    """The D = 96 products' descriptors (``wgmma.cuh``'s text): S = Q K^T
    takes 2 k-steps of 16 columns a 32-column slab, K-major, the second at
    +32 bytes of a row and each slab 4 KB on; O += P V takes one m64n96k16
    a 16-key k-step, V MN-major, 16 rows of 64 bytes (1,024) on, its
    leading byte offset the slabs' stride: the k-steps' columns of Q and K
    and the k-steps' keys of V cover each loaded chunk once, in order."""
    text = (_CSRC / "wgmma.cuh").read_text()
    for formula in (
            "constexpr int kSteps = W / 16;",
            "for (int kk = 0; kk < kSteps * NS; ++kk) {",
            "const int step = (kk / kSteps) * (slab_bytes<W>() >> 4) +\n"
            "                     2 * (kk % kSteps);",
            "const uint64_t db = desc_sw64_lbo(b_s, slab_bytes<32>());",
            "const uint64_t b = db + ((kk * 1024) >> 4);",
            "wgmma_rs96<1>(acc, xh[kk], b, 1);",
            "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16"):
        assert formula in text, formula
    W, NS, slab = 32, 3, 64 * 2 * 32
    # S: k-step kk starts (in 16-byte units) at slab kk / 2, +2 (32 bytes)
    # for the second; it spans 2 chunks (16 bf16) of each row
    cols = []
    for kk in range(W // 16 * NS):
        step = (kk // (W // 16)) * (slab >> 4) + 2 * (kk % (W // 16))
        s, within = divmod(step * 16, slab)
        cols += [s * (W // 8) + within // 16 + h for h in range(2)]
    assert cols == list(range(96 // 8))
    # PV: k-step kk reads keys 16 kk .. 16 kk + 15 of every slab
    keys = [((kk * 1024) // (2 * W)) + j for kk in range(4) for j in range(16)]
    assert keys == list(range(64))

def _variant_tools():
    """(tool, variant) of tools/attention_{bwd,fwd}_variants.py."""
    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tools"))
    import attention_bwd_variants
    import attention_fwd_variants
    return [(tool, name) for tool in (attention_bwd_variants,
                                      attention_fwd_variants)
            for name in tool.VARIANTS]


@pytest.mark.parametrize("tool,name", _variant_tools(),
                         ids=lambda x: getattr(x, "__name__", x))
def test_kernel_variants_apply_to_the_sources(tool, name, tmp_path):
    """Each text variant the timing tools build (the attention backward's
    and forward's) still finds every substitution in the sources exactly
    once (``variant_csrc`` refuses it otherwise), and changes them."""
    dst = tool.variant_csrc(name, tmp_path)
    assert any((dst / f).read_text() != (_CSRC / f).read_text()
               for f in tool.VARIANTS[name])


if __name__ == "__main__":
    print("gradients vs jax.grad of the model attention, worst of dq, dk, "
          f"dv: {max(max(attention_grad_gaps(c)) for c in GRAD_CASES):.2e} "
          f"(RTOL_GRAD {RTOL_GRAD})")
    worst = {"f32": 0.0, "bf16": 0.0}
    for shape in [(1, 2, 256, 64), (2, 1, 128, 128), (1, 4, 512, 64),
                  (2, 2, 256, 96)]:
        arrays = _inputs(shape, shape, 0)
        for dtype in worst:
            for causal in (True, False):
                q, k, v = (jnp.asarray(a, JNP[dtype]) for a in arrays)
                got = _port(arrays, dtype, causal)
                worst[dtype] = max(
                    worst[dtype],
                    _err(got, jax_flash(q, k, v, causal=causal,
                                        interpret=True)),
                    _err(got, jax_attention_ref(q, k, v, causal=causal)))
    print("round_p=True vs Pallas kernel and oracle, max abs err:", worst)
    for case in MODEL_CASES:
        B, S, K, G, hd, window, sink = case
        q, k, v = _model_inputs(B, S, K, G, hd, 4)
        for dtype in ("f32", "bf16"):
            got = ref.attention_ref(*_to_heads(q, k, v, dtype), window=window,
                                    sink=sink, round_p=False)
            got = got.transpose(1, 2).float().numpy()
            want = _jax_model_attention(q, k, v, dtype, window, sink)
            if dtype == "f32":
                print(f"round_p=False {case} f32 vs JAX model: max abs "
                      f"{np.abs(got - want).max() / np.abs(want).max():.2e} "
                      f"of max|jax|")
            else:
                own = ref.bf16_ulp_gaps(torch.tensor(got), torch.tensor(want),
                                        floor=0.0)[0]
                print(f"round_p=False {case} bf16 vs JAX model: (ulps, "
                      f"share differing) {bf16_ulp_gaps(got, want)}, "
                      f"{own:.0f} ulps of the element's own magnitude")
    print("global layer vs JAX causal_attention, (ulps, share) by round_p:",
          _global_layer_gaps())
    import jax
    jcfg = dataclasses.replace(
        jax_reduce_config(jax_get_config("hymba-1.5b")), dtype="bfloat16")
    cfg = reduce_config(get_config("hymba-1.5b")).replace(dtype="bfloat16")
    jparams = jax.jit(JaxLM(jcfg).init)(jax.random.key(1))
    params = convert.lm_params_from_numpy(
        cfg, jax.tree.map(np.asarray, jparams), device="cpu")
    for seg, window in (("full0", None), ("swa0", 16)):
        sink = cfg.meta_tokens if window is not None else 0
        S = cfg.meta_tokens + 40
        x = np.random.default_rng(7).normal(size=(2, S, cfg.d_model)).astype(
            np.float32)
        jout, _ = jax_attn.attn_block(
            {k: v[0] for k, v in jparams[seg]["attn"].items()},
            jnp.asarray(x, jnp.bfloat16), jcfg, jnp.arange(S), window=window,
            sink=sink)
        out, _ = attn.attn_block(
            {k: v[0] for k, v in params[seg]["attn"].items()},
            torch.from_numpy(x).bfloat16(), cfg, torch.arange(S),
            window=window, sink=sink)
        got, want = out.float().numpy(), np.asarray(jout.astype(jnp.float32))
        gap = np.abs(got - want)
        print(f"attn_block {seg} bf16 vs JAX: max gap "
              f"{gap.max() / np.abs(want).max():.2e} of max|jax|, share "
              f"differing {(gap > 0).mean():.4f}")
