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
