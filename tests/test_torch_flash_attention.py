"""The flash-attention plain version of the PyTorch port (what the wrapper
runs on the CPU and what the CUDA kernel is held to on the card) against the
JAX reference: its Pallas kernel in interpret mode and its oracle
``repro.kernels.ref.attention_ref``.

Tolerances are the reference's own gate for its kernel
(``tests/test_kernels.py``): 2e-5 for float32 and 2e-2 for bfloat16, atol
and rtol alike. Measured worst case on the CPU at the reference's shapes:
7.2e-7 for float32 and 7.8e-3 for bfloat16 (max abs err;
``python tests/test_torch_flash_attention.py`` prints them).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as jax_flash
from repro.kernels.ref import attention_ref as jax_attention_ref
from repro_torch.kernels import flash_attention as kflash
from repro_torch.kernels import ref

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
    # neither the CPU nor a CUDA device: no plain-version fallback
    with pytest.raises(ValueError, match="cuda or cpu"):
        kflash.flash_attention(q.to("meta"), kv.to("meta"), kv.to("meta"))


if __name__ == "__main__":
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
    print("plain version vs Pallas kernel and oracle, max abs err:", worst)
