"""The hymba serving slice of the PyTorch port against the JAX package, on
the CPU, at the reduced configuration (``reduce_config``: 4 layers, d_model
64, window 16, 4 meta tokens, float32) with the JAX weights carried across
by ``convert.lm_params_from_numpy``.

Every float check is ``max|port - jax| <= RTOL * max|jax|`` over the whole
tensor (elementwise relative error is meaningless for entries near zero).
Measured against live JAX (``python tests/test_torch_serve.py`` prints
them): prefill logits within 8.0e-6 and cache leaves within 1.6e-5,
teacher-forced decode logits within 1.9e-5 and the caches after decode
within 1.5e-5; RTOL = 1e-4 leaves a margin of 5. The gap is float32
rounding (matmul summation order, rsqrt, exp) that grows by about 5-10x
per layer through the random-weight network (2e-7 in layer 0's keys, 1.6e-5
in layer 3's), not the scan: the port's sequential scan and the JAX chunked
associative scan agree to 1e-7 relative on their own
(tests/test_torch_ssm_scan.py). Greedy tokens, positions and ring slots
must be identical.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduce_config as jax_reduce_config
from repro.models import LM as JaxLM
from repro.serve.engine import Engine as JaxEngine
from repro_torch import convert
from repro_torch.configs import get_config, reduce_config
from repro_torch.models import LM
from repro_torch.serve.engine import Engine

RTOL = 1e-4              # port vs JAX: logits and every cache leaf
RTOL_SELF = 2e-2         # decode vs prefill, the reference's own gate


@pytest.fixture(scope="module")
def models():
    jcfg = jax_reduce_config(jax_get_config("hymba-1.5b"))
    cfg = reduce_config(get_config("hymba-1.5b"))
    jlm = JaxLM(jcfg)
    jparams = jax.jit(jlm.init)(jax.random.key(0))
    params = convert.lm_params_from_numpy(
        cfg, jax.tree.map(np.asarray, jparams), device="cpu")
    return jcfg, jlm, jparams, cfg, LM(cfg, device="cpu"), params


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


def _cache_gaps(cache, jcache):
    """{leaf path: relative gap}; positions and ring slots compared exactly."""
    mine = dict(_leaves(cache))
    theirs = dict(_leaves(jcache))
    assert sorted(mine) == sorted(theirs)
    gaps = {}
    for path, want in theirs.items():
        got = mine[path]
        if path == "/pos" or path.endswith("ring_pos"):
            assert np.array_equal(np.asarray(got), np.asarray(want)), path
        else:
            gaps[path] = _rel(got.numpy(), want)
    return gaps


def _tokens(cfg, B, S, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)


def _prefill_gaps(models, S0, max_seq):
    jcfg, jlm, jparams, cfg, lm, params = models
    toks = _tokens(cfg, 2, S0, S0)
    jcache, jlogits = jax.jit(lambda p, b: jlm.prefill(p, b, max_seq=max_seq))(
        jparams, {"tokens": toks})
    cache, logits = lm.prefill(params, {"tokens": toks}, max_seq=max_seq)
    return _rel(logits.numpy(), jlogits), _cache_gaps(cache, jcache)


# 12 text tokens fill the 16-slot ring partly, 20 overfill it
@pytest.mark.parametrize("S0", [12, 20])
def test_prefill_logits_and_every_cache_leaf_match_jax(models, S0):
    logit_gap, cache_gaps = _prefill_gaps(models, S0, max_seq=S0 + 8)
    assert logit_gap <= RTOL
    assert max(cache_gaps.values()) <= RTOL, cache_gaps


def _decode_gaps(models, S0=12, N=10):
    """Prefill S0 text tokens, then N teacher-forced decode steps: the ring
    of 16 slots wraps after 4 of them."""
    jcfg, jlm, jparams, cfg, lm, params = models
    toks = _tokens(cfg, 2, S0 + N, 7)
    max_seq = S0 + N + 4
    jcache, _ = jax.jit(lambda p, b: jlm.prefill(p, b, max_seq=max_seq))(
        jparams, {"tokens": toks[:, :S0]})
    cache, _ = lm.prefill(params, {"tokens": toks[:, :S0]}, max_seq=max_seq)
    jdecode = jax.jit(jlm.decode)
    worst = 0.0
    for t in range(S0, S0 + N):
        jlogits, jcache = jdecode(jparams, jcache, {"tokens": toks[:, t]})
        logits, cache = lm.decode(params, cache, {"tokens": toks[:, t]})
        worst = max(worst, _rel(logits.numpy(), jlogits))
    return worst, _cache_gaps(cache, jcache)


def test_teacher_forced_decode_matches_jax_through_ring_wraparound(models):
    logit_gap, cache_gaps = _decode_gaps(models)
    assert logit_gap <= RTOL
    assert max(cache_gaps.values()) <= RTOL, cache_gaps


def test_engine_greedy_tokens_match_jax(models):
    jcfg, jlm, jparams, cfg, lm, params = models
    batch = {"tokens": _tokens(cfg, 4, 12, 0)}
    want = JaxEngine(jcfg, jparams, max_seq=48).generate(batch, steps=24)
    engine = Engine(cfg, params, max_seq=48, device="cpu")
    got = engine.generate(batch, steps=24)
    assert got.dtype == np.int32 and got.shape == (4, 24)
    assert np.array_equal(got, want)
    assert np.array_equal(engine.generate(batch, steps=24), got)


def _self_gap(models):
    """The port's own decode-vs-prefill consistency, as
    tests/test_models.py::test_decode_matches_prefill checks the
    reference: prefill(prefix) + N decode steps vs prefill(whole)."""
    cfg, lm, params = models[3:]
    B, S0, N = 2, 16, 8
    toks = _tokens(cfg, B, S0 + N, 1)
    max_seq = S0 + N + 4
    cache, logits = lm.prefill(params, {"tokens": toks[:, :S0]},
                               max_seq=max_seq)
    for t in range(S0, S0 + N):
        logits, cache = lm.decode(params, cache, {"tokens": toks[:, t]})
    _, logits_full = lm.prefill(params, {"tokens": toks}, max_seq=max_seq)
    return logits.numpy(), logits_full.numpy()


def test_decode_matches_prefill(models):
    logits, logits_full = _self_gap(models)
    np.testing.assert_allclose(logits, logits_full, rtol=RTOL_SELF,
                               atol=RTOL_SELF)


# Decode vs prefill across depth (ROADMAP.md §3): at full width the port's
# gap grows ~10x per doubling of depth (PERF.md). The JAX model, with
# the same weights, shows the same growth: at this width (d_model 256, head
# dim 64) its gap is 9e-7, 3e-6, 1.3e-5 and 4e-4 of the largest logit at 1,
# 2, 4 and 8 layers, the port's 6e-7, 1.6e-6, 3.8e-5 and 2.8e-4 (``python
# tests/test_torch_serve.py`` prints them), so the growth is the model's
# float32 rounding through random weights, not a fault of the port.
DEPTH_WIDTH = dict(d_model=256, num_heads=4, head_dim=64)
DEPTH_GAP_RATIO = 10.0   # port gap within 10x of the JAX model's, each way


def _depth_gaps(depth, S0=24, N=8):
    """(JAX gap, port gap): max|logits after prefill(S0) + N decode steps -
    logits of prefill(S0 + N)| / max|prefill logits|, float32, the reduced
    hymba at ``DEPTH_WIDTH`` cut to ``depth`` layers (the ring of 16 slots
    wraps), JAX weights carried to the port by ``convert``."""
    kw = dict(DEPTH_WIDTH, num_layers=depth,
              full_attn_every=(0,) if depth <= 2 else
              (0, depth // 2 - 1, depth - 1))
    jcfg = jax_reduce_config(jax_get_config("hymba-1.5b")).replace(**kw)
    cfg = reduce_config(get_config("hymba-1.5b")).replace(**kw)
    jlm = JaxLM(jcfg)
    jparams = jax.jit(jlm.init)(jax.random.key(0))
    params = convert.lm_params_from_numpy(
        cfg, jax.tree.map(np.asarray, jparams), device="cpu")
    lm = LM(cfg, device="cpu")
    toks = _tokens(cfg, 2, S0 + N, 1)
    max_seq = S0 + N + 4
    jprefill = jax.jit(lambda p, b: jlm.prefill(p, b, max_seq=max_seq))
    jdecode = jax.jit(jlm.decode)
    jcache, jlogits = jprefill(jparams, {"tokens": toks[:, :S0]})
    for t in range(S0, S0 + N):
        jlogits, jcache = jdecode(jparams, jcache, {"tokens": toks[:, t]})
    _, jfull = jprefill(jparams, {"tokens": toks})
    with torch.inference_mode():
        cache, logits = lm.prefill(params, {"tokens": toks[:, :S0]},
                                   max_seq=max_seq)
        for t in range(S0, S0 + N):
            logits, cache = lm.decode(params, cache, {"tokens": toks[:, t]})
        _, full = lm.prefill(params, {"tokens": toks}, max_seq=max_seq)
    return _rel(jlogits, jfull), _rel(logits.numpy(), full.numpy())


@pytest.mark.parametrize("depth", [1, 2, 4, 8])
def test_decode_vs_prefill_gap_grows_with_depth_as_in_the_jax_model(depth):
    jax_gap, port_gap = _depth_gaps(depth)
    if depth == 8:      # the width is one where the growth shows
        assert jax_gap > 1e-5
    assert jax_gap / DEPTH_GAP_RATIO <= port_gap <= DEPTH_GAP_RATIO * jax_gap


def test_full_width_parameter_tree_matches_jax():
    """Every name, shape and dtype of the unreduced hymba-1.5b tree (bf16,
    32 layers) against the reference's, without allocating either."""
    spec = LM(get_config("hymba-1.5b"), device="meta").init()
    jspec = jax.eval_shape(JaxLM(jax_get_config("hymba-1.5b")).init,
                           jax.random.key(0))
    mine = {p: (tuple(t.shape), str(t.dtype).replace("torch.", ""))
            for p, t in _leaves(spec)}
    theirs = {p: (tuple(t.shape), str(t.dtype)) for p, t in _leaves(jspec)}
    assert mine == theirs
    n_params = sum(int(np.prod(s)) for s, _ in mine.values())
    assert 1.5e9 < n_params < 1.7e9


def test_config_registry_and_unported_families():
    """The reference's 10 architectures are registered, each field for
    field its config (full and reduced); other names raise a KeyError
    naming what is registered; ``LM`` builds for every config, full and
    reduced (every family is ported); a gradient through MLA's attention
    on the card (its value head dim apart from the query/key one; meta
    tensors stand in for the card's here) raises NotImplementedError
    pointing at ROADMAP.md; ``LM.loss`` of hymba returns a loss, and a MoE
    configuration builds a train step."""
    import dataclasses
    from repro.configs import ALL_ARCHS
    from repro_torch.configs import list_archs
    from repro_torch.kernels.flash_attention import flash_attention
    assert list_archs() == ALL_ARCHS and len(ALL_ARCHS) == 10
    for arch in ALL_ARCHS:
        cfg, jcfg = get_config(arch), jax_get_config(arch)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg), arch
        assert dataclasses.asdict(reduce_config(cfg)) == dataclasses.asdict(
            jax_reduce_config(jcfg)), arch
        LM(reduce_config(cfg), device="cpu")
        assert LM(cfg, device="meta").plan
    with pytest.raises(KeyError, match="hymba-1.5b"):
        get_config("qwen3-9b")
    small = reduce_config(get_config("hymba-1.5b"))
    q, k = (torch.zeros((1, 4, 8, 24), device="meta", requires_grad=True)
            for _ in range(2))
    v = torch.zeros((1, 4, 8, 16), device="meta", requires_grad=True)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        flash_attention(q, k, v, round_p=False)
    lm = LM(small, device="cpu")
    loss, _ = lm.loss(lm.init(torch.Generator().manual_seed(0)),
                      {"tokens": np.zeros((1, 8), np.int32)})
    assert torch.isfinite(loss)
    from repro_torch.train.step import make_train_step
    make_train_step(reduce_config(get_config("moonshot-v1-16b-a3b")),
                    device="cpu")


def test_launcher_serves_the_reduced_model_on_the_cpu(capsys):
    from repro_torch.launch import serve
    out = serve.main(["--device", "cpu", "--reduced", "--requests", "3",
                      "--prompt-len", "10", "--steps", "5", "--seed", "2"])
    assert out.shape == (3, 5) and out.dtype == np.int32
    assert "hymba-1.5b on cpu: generated (3, 5)" in capsys.readouterr().out


def test_init_cache_has_the_reference_layout(models):
    """``init_cache``: every leaf's name, shape and dtype, and its values
    (zeros, ring slots -1, pos = total - 1), as the reference has them."""
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


def test_convert_rejects_a_tree_that_does_not_fit(models):
    jcfg, jlm, jparams, cfg, lm, params = models
    tree = jax.tree.map(np.asarray, jparams)
    bad_name = dict(tree, extra=tree["ln_f"])
    with pytest.raises(KeyError):
        convert.lm_params_from_numpy(cfg, bad_name, device="cpu")
    bad_shape = dict(tree, ln_f=tree["ln_f"][:-1])
    with pytest.raises(ValueError, match="ln_f"):
        convert.lm_params_from_numpy(cfg, bad_shape, device="cpu")
    bad_dtype = dict(tree, ln_f=tree["ln_f"].astype(np.float64))
    with pytest.raises(TypeError, match="ln_f"):
        convert.lm_params_from_numpy(cfg, bad_dtype, device="cpu")


if __name__ == "__main__":
    with torch.no_grad():
        m = models.__wrapped__()
        for S0 in (12, 20):
            logit_gap, gaps = _prefill_gaps(m, S0, S0 + 8)
            print(f"prefill S0={S0}: logits {logit_gap:.3e}, worst cache "
                  f"leaf {max(gaps.values()):.3e} ({max(gaps, key=gaps.get)})")
        logit_gap, gaps = _decode_gaps(m)
        print(f"teacher-forced decode: logits {logit_gap:.3e}, worst cache "
              f"leaf {max(gaps.values()):.3e} ({max(gaps, key=gaps.get)})")
        logits, full = _self_gap(m)
        print(f"decode vs prefill (port only): max abs "
              f"{np.abs(logits - full).max():.3e}")
    for depth in (1, 2, 4, 8):
        jax_gap, port_gap = _depth_gaps(depth)
        print(f"decode vs prefill, {depth} layers at {DEPTH_WIDTH}: JAX "
              f"{jax_gap:.3e}, port {port_gap:.3e} of max |logit|")
