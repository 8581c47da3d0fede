"""The last three LM families of the PyTorch port against the JAX package,
on the CPU, at the reduced configurations (``reduce_config``: 4 layers,
d_model 64, 4 heads, float32) with the JAX weights carried across by
``convert.lm_params_from_numpy``: xlstm-125m (mLSTM and sLSTM layers, the
sLSTM at layer 1), phi-3-vision-4.2b (8 patches of 32 through the projector
in front of the text) and musicgen-medium (4 codebooks, cross attention
over 8 condition tokens of 32).

Every float check is ``max|port - jax| <= RTOL * max|jax|`` over a tensor.
Measured against live JAX (``python tests/test_torch_families.py`` prints
them): prefill logits within 8.6e-6 and cache leaves (the xLSTM states
included) within 1.1e-5; teacher-forced decode logits within 2.9e-5 and
the caches after decode within 1.1e-5 (phi-3-vision and musicgen, whose
attention layers carry the most rounding; xlstm 2.6e-6); the loss within
1.7e-7 and every gradient leaf within 7.2e-4 (musicgen's ``mlp/wi``;
xlstm 1.0e-4, phi-3-vision 2.6e-4); three train steps within 1.1e-5 on
the loss (phi-3-vision's third step; xlstm 1.7e-7, musicgen 7.3e-7) and
1.9e-4 on grad_norm; ``mlstm_block`` / ``slstm_block`` alone within 9.1e-7
on the output and 3.7e-7 on the states at S = 12, 64, 128 and 130;
``cross_attn_block`` within 7.1e-7 (float32), bit-equal in bf16. The
gates: RTOL 1e-4 as the hymba serving slice's (tests/test_torch_serve.py);
the loss 1e-5 and the gradients 2e-3 as the training gates of
tests/test_torch_train.py; the three steps that file's ``RTOL_STEP`` but
the loss's 2e-5, since phi-3-vision's third loss moves by 1.09e-5 for one
reason: one entry of its first embedding gradient cancels to 5e-7 of the
leaf's scale (1.0e-5 in JAX, -6e-7 here), and AdamW's first steps move
every entry by about lr whatever the gradient's size, so that entry moves
the opposite way in the two packages. Greedy tokens must be identical.
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
from repro.models import attention as jax_attention
from repro.models import xlstm as jax_xlstm
from repro.optim import adamw as jax_adamw
from repro.serve.engine import Engine as JaxEngine
from repro.train.step import make_train_step as jax_make_train_step
from repro_torch import convert
from repro_torch.configs import get_config, reduce_config
from repro_torch.models import LM
from repro_torch.models import attention, xlstm
from repro_torch.optim import adamw
from repro_torch.serve.engine import Engine
from repro_torch.train.step import make_train_step

RTOL = 1e-4               # logits and every cache leaf
RTOL_BLOCK = 1e-5         # one xLSTM or cross-attention block alone
RTOL_LOSS = 1e-5
RTOL_GRAD = 2e-3
# 3 train steps: tests/test_torch_train.py's gates, but the loss's 2e-5 (see
# the module docstring: one AdamW step of +-lr on an entry whose gradient
# cancels to rounding)
RTOL_STEP = {"loss": 2e-5, "grad_norm": RTOL_GRAD, "lr": 0.0}
RTOL_SELF = 2e-2          # decode vs prefill, the reference's own gate
ARCHS = ["xlstm-125m", "phi-3-vision-4.2b", "musicgen-medium"]
B, SEQ, SEED = 4, 24, 3   # the training batch (vision: 16 text tokens)


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
    if scale == 0:
        return float(np.abs(got).max())
    return float(np.abs(got - want).max() / scale)


def _cache_gaps(cache, jcache):
    mine, theirs = dict(_leaves(cache)), dict(_leaves(jcache))
    assert sorted(mine) == sorted(theirs)
    assert mine["/pos"] == int(theirs["/pos"])
    return {p: _rel(mine[p].numpy(), w) for p, w in theirs.items()
            if p != "/pos"}


def _prompt(cfg, b, s, seed):
    """A prefill batch of ``s`` text tokens (or audio frames) and, with
    it, the decode batch of position t (``step(t)``)."""
    rng = np.random.default_rng(seed)
    if cfg.audio_codebooks:
        codes = rng.integers(0, cfg.vocab_size,
                             (b, cfg.audio_codebooks, s)).astype(np.int32)
        cond = rng.normal(size=(b, cfg.cond_len, cfg.cond_dim)).astype(
            np.float32)
        return ({"codes": codes, "cond": cond},
                lambda t, n=None: ({"codes": codes[:, :, :t], "cond": cond}
                                   if n == "prefix" else
                                   {"tokens": codes[:, :, t], "cond": cond}))
    toks = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    extra = {}
    if cfg.vision:
        extra["patches"] = rng.normal(
            size=(b, cfg.num_patches, cfg.vision_dim)).astype(np.float32)
    return ({"tokens": toks, **extra},
            lambda t, n=None: ({"tokens": toks[:, :t], **extra}
                               if n == "prefix" else {"tokens": toks[:, t]}))


def _prefill_gaps(m, S0=12, max_seq=24):
    jcfg, jlm, jparams, cfg, lm, params = m
    batch, _ = _prompt(cfg, 2, S0, S0)
    jcache, jlogits = jax.jit(lambda p, b: jlm.prefill(p, b, max_seq=max_seq))(
        jparams, batch)
    with torch.inference_mode():
        cache, logits = lm.prefill(params, batch, max_seq=max_seq)
    return _rel(logits.numpy(), jlogits), _cache_gaps(cache, jcache)


def test_prefill_logits_and_every_cache_leaf_match_jax(models):
    """Logits ((B, nq, V) for audio) and every cache leaf: the xLSTM
    states, and the KV caches laid out over max_seq + the patches."""
    logit_gap, cache_gaps = _prefill_gaps(models)
    assert logit_gap <= RTOL
    assert max(cache_gaps.values()) <= RTOL, cache_gaps


def _decode_gaps(m, S0=12, N=8):
    jcfg, jlm, jparams, cfg, lm, params = m
    _, step = _prompt(cfg, 2, S0 + N, 7)
    max_seq = S0 + N + 4
    jcache, _ = jax.jit(lambda p, b: jlm.prefill(p, b, max_seq=max_seq))(
        jparams, step(S0, "prefix"))
    jdecode = jax.jit(jlm.decode)
    worst = 0.0
    with torch.inference_mode():
        cache, _ = lm.prefill(params, step(S0, "prefix"), max_seq=max_seq)
        for t in range(S0, S0 + N):
            jlogits, jcache = jdecode(jparams, jcache, step(t))
            logits, cache = lm.decode(params, cache, step(t))
            worst = max(worst, _rel(logits.numpy(), jlogits))
    return worst, _cache_gaps(cache, jcache)


def test_teacher_forced_decode_matches_jax(models):
    logit_gap, cache_gaps = _decode_gaps(models)
    assert logit_gap <= RTOL
    assert max(cache_gaps.values()) <= RTOL, cache_gaps


def test_engine_greedy_tokens_match_jax(models):
    """(B, steps) tokens, (B, steps, nq) for audio, the condition carried
    into every decode step."""
    jcfg, jlm, jparams, cfg, lm, params = models
    batch, _ = _prompt(cfg, 3, 10, 0)
    want = JaxEngine(jcfg, jparams, max_seq=32).generate(batch, steps=12)
    engine = Engine(cfg, params, max_seq=32, device="cpu")
    got = engine.generate(batch, steps=12)
    shape = (3, 12) + ((cfg.audio_codebooks,) if cfg.audio_codebooks else ())
    assert got.dtype == np.int32 and got.shape == shape
    assert np.array_equal(got, want)
    assert np.array_equal(engine.generate(batch, steps=12), got)


def test_decode_matches_prefill(models):
    """The port's own decode-vs-prefill consistency (the reference's
    tests/test_models.py gate)."""
    cfg, lm, params = models[3:]
    _, step = _prompt(cfg, 2, 20, 1)
    with torch.inference_mode():
        cache, logits = lm.prefill(params, step(14, "prefix"), max_seq=24)
        for t in range(14, 20):
            logits, cache = lm.decode(params, cache, step(t))
        _, full = lm.prefill(params, step(20, "prefix"), max_seq=24)
    np.testing.assert_allclose(logits.numpy(), full.numpy(), rtol=RTOL_SELF,
                               atol=RTOL_SELF)


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
    # decode writes the states in place: no two leaves share storage
    ptrs = [t.data_ptr() for p, t in got.items() if p != "/pos"]
    assert len(set(ptrs)) == len(ptrs)


# ---------------------------------------------------------------------------
# training: the loss, every gradient leaf, three steps
# ---------------------------------------------------------------------------


def _train_ref(arch):
    jcfg, cfg = _cfgs(arch)
    jlm = JaxLM(jcfg)
    jparams = jax.jit(jlm.init)(jax.random.key(0))
    batch = JaxData(jcfg, B, SEQ, seed=SEED).next_batch()
    (loss, _), grads = jax.jit(jax.value_and_grad(
        lambda p, b: jlm.loss(p, b), has_aux=True))(jparams, batch)
    return {"cfg": cfg, "jcfg": jcfg, "jparams": jparams, "batch": batch,
            "loss": float(loss), "grads": grads,
            "np_params": jax.tree.map(np.asarray, jparams)}


@pytest.fixture(scope="module", params=ARCHS)
def train_ref(request):
    return _train_ref(request.param)


def _port_loss_and_grads(ref, remat="full"):
    params = convert.lm_params_from_numpy(ref["cfg"], ref["np_params"],
                                          device="cpu")
    flat = adamw.leaves(params)
    for t in flat:
        t.requires_grad_(True)
    loss, _ = LM(ref["cfg"], device="cpu").loss(params, ref["batch"],
                                                remat=remat)
    return loss, torch.autograd.grad(loss, flat)


def loss_gaps(ref):
    loss, grads = _port_loss_and_grads(ref)
    flat = jax.tree_util.tree_flatten_with_path(ref["grads"])[0]
    assert len(flat) == len(grads)
    return (abs(loss.item() - ref["loss"]) / abs(ref["loss"]),
            {jax.tree_util.keystr(path): _rel(g.numpy(), want)
             for (path, want), g in zip(flat, grads)})


def test_loss_and_every_gradient_leaf_match_jax(train_ref):
    """The vision loss skips the patches; the audio loss is the mean of
    the codebooks' losses; the xLSTM recurrence runs checkpointed per
    64-step chunk (here one chunk of 24)."""
    loss_gap, grads = loss_gaps(train_ref)
    assert loss_gap <= RTOL_LOSS
    worst = max(grads, key=grads.get)
    assert grads[worst] <= RTOL_GRAD, (worst, grads[worst])


@pytest.mark.parametrize("remat", ["none", "dots"])
def test_remat_policies_give_the_same_gradients(train_ref, remat):
    """Each remat policy around the layer, the xLSTM chunk checkpoints
    nested inside it: the loss and the gradients of ``full``."""
    loss, grads = _port_loss_and_grads(train_ref)
    other, other_grads = _port_loss_and_grads(train_ref, remat=remat)
    assert other.item() == loss.item()
    for g, h in zip(grads, other_grads):
        assert _rel(h.numpy(), g.numpy()) <= 1e-6


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
    return gaps


def test_three_train_steps_match_jax(train_ref):
    gaps = train_gaps(train_ref)
    for k, tol in RTOL_STEP.items():
        assert max(g[k] for g in gaps) <= tol, (k, gaps)


# ---------------------------------------------------------------------------
# the modules alone
# ---------------------------------------------------------------------------


def _xlstm_case(kind, S, seed=0):
    jcfg, cfg = _cfgs("xlstm-125m")
    init = {"mlstm": jax_xlstm.init_mlstm, "slstm": jax_xlstm.init_slstm}
    jp = init[kind](jax.random.key(seed), jcfg, jnp.float32)
    p = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), jp)
    x = np.random.default_rng(seed).normal(
        size=(2, S, jcfg.d_model)).astype(np.float32)
    return jcfg, cfg, jp, p, x


def xlstm_block_gaps(kind, S):
    jcfg, cfg, jp, p, x = _xlstm_case(kind, S)
    jblock = {"mlstm": jax_xlstm.mlstm_block, "slstm": jax_xlstm.slstm_block}
    block = {"mlstm": xlstm.mlstm_block, "slstm": xlstm.slstm_block}
    jy, jstate = jax.jit(lambda p_, x_: jblock[kind](p_, x_, jcfg))(jp, x)
    with torch.inference_mode():
        y, state = block[kind](p, torch.from_numpy(x), cfg)
    return (_rel(y.numpy(), jy),
            max(_rel(s.numpy(), js) for s, js in zip(state, jstate)))


@pytest.mark.parametrize("S", [12, 64, 128, 130])
@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_xlstm_block_matches_jax(kind, S):
    """One chunk (12, 64), two chunks (128) and a length no chunk divides
    (130: one chunk of 130): the output and the final states."""
    y_gap, state_gap = xlstm_block_gaps(kind, S)
    assert y_gap <= RTOL_BLOCK and state_gap <= RTOL_BLOCK


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_chunk_checkpoints_keep_the_gradients(kind, monkeypatch):
    """At S = 130 in chunks of 13 (checkpointed) and of 130 (one chunk):
    the same output and, bit for bit, the same gradients; the recurrence
    is not recomputed without autograd."""
    jcfg, cfg, jp, p, x = _xlstm_case(kind, 130)
    block = {"mlstm": xlstm.mlstm_block, "slstm": xlstm.slstm_block}[kind]
    runs = []
    for chunk in (13, 130):
        leaves = [t.clone().requires_grad_(True) for t in p.values()]
        pp = dict(zip(p, leaves))
        y, _ = block(pp, torch.from_numpy(x), cfg, chunk=chunk)
        runs.append((y.detach(), torch.autograd.grad(y.square().sum(),
                                                     leaves)))
    assert torch.equal(runs[0][0], runs[1][0])
    assert all(torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))
    calls = []
    monkeypatch.setattr(xlstm, "checkpoint",
                        lambda *a, **k: calls.append(1))
    with torch.no_grad():
        block(p, torch.from_numpy(x), cfg, chunk=13)
    assert not calls


def test_slstm_init_keeps_the_reference_wg_equal_to_wu():
    """The reference draws wu from wg's key: equal at init (kept)."""
    cfg = reduce_config(get_config("xlstm-125m"))
    p = xlstm.init_slstm(torch.Generator().manual_seed(0), cfg,
                         torch.float32, "cpu")
    assert torch.equal(p["wg"], p["wu"])
    assert p["wg"].data_ptr() != p["wu"].data_ptr()
    jp = jax_xlstm.init_slstm(jax.random.key(0), _cfgs("xlstm-125m")[0],
                              jnp.float32)
    assert np.array_equal(np.asarray(jp["wg"]), np.asarray(jp["wu"]))


def cross_attn_gap(dtype=jnp.float32, seed=0):
    jcfg, cfg = _cfgs("musicgen-medium")
    jp = jax_attention.init_cross_attn(jax.random.key(seed), jcfg, dtype)
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(2, 11, jcfg.d_model)).astype(np.float32)
    cond = rng.normal(size=(2, jcfg.cond_len, jcfg.d_model)).astype(
        np.float32)
    want = jax_attention.cross_attn_block(jp, jnp.asarray(x, dtype),
                                          jnp.asarray(cond, dtype))
    p = jax.tree.map(lambda a: torch.from_numpy(np.array(a, np.float32)).to(
        torch.float32 if dtype == jnp.float32 else torch.bfloat16), jp)
    tdt = p["wq"].dtype
    got = attention.cross_attn_block(p, torch.from_numpy(x).to(tdt),
                                     torch.from_numpy(cond).to(tdt))
    assert got.dtype == tdt
    return _rel(got.float().numpy(), np.asarray(want, np.float32))


def test_cross_attn_block_matches_jax():
    """Non-causal over the condition, float32 scores and softmax; in
    bf16 within 2 bf16 ulps of the output's scale."""
    assert cross_attn_gap() <= RTOL_BLOCK
    assert cross_attn_gap(jnp.bfloat16) <= 2 * 2.0 ** -8


def test_vision_loss_ignores_the_patch_prefix():
    """The loss reads only the text positions: a change of the patches
    moves it (they are attended), a change of the labels moves it, but
    the positions in front of the text predict nothing: the loss equals
    the cross entropy over the text positions alone."""
    from repro_torch.models.common import chunked_cross_entropy, rmsnorm
    cfg = reduce_config(get_config("phi-3-vision-4.2b"))
    lm = LM(cfg, device="cpu")
    params = lm.init(torch.Generator().manual_seed(2))
    batch, _ = _prompt(cfg, 2, 9, 2)
    with torch.no_grad():
        loss, _ = lm.loss(params, batch)
        x, _ = lm._embed_inputs(params, batch)
        assert x.shape[1] == cfg.num_patches + 9
        x, _ = lm._run_segments(params, x, torch.arange(x.shape[1]))
        h = rmsnorm(x, params["ln_f"])[:, cfg.num_patches:]
        want = chunked_cross_entropy(h[:, :-1], params["head"],
                                     torch.from_numpy(batch["tokens"][:, 1:])
                                     .long())
        other = dict(batch, patches=batch["patches"] + 1.0)
        moved, _ = lm.loss(params, other)
    assert loss.item() == want.item()
    assert moved.item() != loss.item()


def test_codebook_embeddings_sum_in_the_reference_order():
    """In bf16 the order of the sum shows: the port's summed codebook
    embeddings (0 + e_0 + e_1 + ...) equal the reference's bit for bit, and
    the audio loss is the mean of the codebooks' losses."""
    jcfg = jax_reduce_config(jax_get_config("musicgen-medium")).replace(
        dtype="bfloat16")
    cfg = reduce_config(get_config("musicgen-medium")).replace(
        dtype="bfloat16")
    jlm, lm = JaxLM(jcfg), LM(cfg, device="cpu")
    jparams = jax.jit(jlm.init)(jax.random.key(1))
    params = convert.lm_params_from_numpy(
        cfg, jax.tree.map(np.asarray, jparams), device="cpu")
    batch, _ = _prompt(cfg, 2, 16, 4)
    jx, _, _ = jlm._embed_inputs(jparams, batch)
    x, cond = lm._embed_inputs(params, batch)
    assert x.dtype == torch.bfloat16 and cond.shape == (2, 8, 64)
    assert np.array_equal(x.float().numpy(), np.asarray(jx, np.float32))
    reversed_sum = sum(params["embed"][k][torch.from_numpy(
        batch["codes"][:, k]).long()] for k in reversed(range(4)))
    assert not torch.equal(reversed_sum, x)


def test_launcher_serves_reduced_musicgen_and_xlstm_on_the_cpu(capsys):
    from repro_torch.launch import serve
    out = serve.main(["--arch", "musicgen-medium", "--reduced", "--device",
                      "cpu", "--prompt-len", "6", "--steps", "3"])
    assert out.shape == (4, 3, 4) and out.dtype == np.int32
    assert ((0 <= out) & (out < 256)).all()
    out = serve.main(["--arch", "xlstm-125m", "--reduced", "--device",
                      "cpu", "--prompt-len", "6", "--steps", "3"])
    assert out.shape == (4, 3)
    assert "generated (4, 3)" in capsys.readouterr().out


def test_launcher_refuses_a_vision_config(capsys):
    from repro_torch.launch import serve
    with pytest.raises(SystemExit):
        serve.main(["--arch", "phi-3-vision-4.2b", "--reduced", "--device",
                    "cpu"])
    err = capsys.readouterr().err
    assert "patches" in err and "Engine.generate" in err


def test_convert_rejects_a_tree_that_does_not_fit():
    """The new trees carry across only whole: a missing condition
    projection, a codebook head of the wrong shape or a bf16 gate bias of
    an xLSTM layer (float32 in both packages) is refused."""
    for arch, edit, err in (
            ("musicgen-medium", lambda t: t.pop("cond_proj"), KeyError),
            ("musicgen-medium",
             lambda t: t.update(heads=t["heads"][:, :, :-1]), ValueError),
            ("xlstm-125m", lambda t: t["mlstm0"]["core"].update(
                b_if=t["mlstm0"]["core"]["b_if"].astype(jnp.bfloat16)),
             TypeError)):
        jcfg, cfg = _cfgs(arch)
        tree = jax.tree.map(np.asarray, JaxLM(jcfg).init(jax.random.key(0)))
        convert.lm_params_from_numpy(cfg, tree, device="cpu")
        edit(tree)
        with pytest.raises(err):
            convert.lm_params_from_numpy(cfg, tree, device="cpu")


def test_sample_temperature_takes_codebook_logits():
    from repro_torch.serve.engine import sample_temperature
    logits = torch.randn(3, 4, 16, generator=torch.Generator().manual_seed(0))
    logits[..., 5] += 100.0
    tok = sample_temperature(torch.Generator().manual_seed(1), logits, 0.8)
    assert tok.shape == (3, 4) and tok.dtype == torch.int32
    assert (tok == 5).all()


# ---------------------------------------------------------------------------
# the full-width configurations
# ---------------------------------------------------------------------------

# parameters of the unreduced trees (jax.eval_shape of the JAX LM.init)
N_PARAMS = {"xlstm-125m": 198_916_688, "phi-3-vision-4.2b": 3_833_662_464,
            "musicgen-medium": 1_838_507_520}


@pytest.mark.parametrize("arch", ARCHS)
def test_full_width_parameter_tree_matches_jax(arch):
    """Every name, shape and dtype of the unreduced tree against the
    reference's (the float32 gate biases included), without allocating
    either."""
    spec = LM(get_config(arch), device="meta").init()
    jspec = jax.eval_shape(JaxLM(jax_get_config(arch)).init,
                           jax.random.key(0))
    mine = {p: (tuple(t.shape), str(t.dtype).replace("torch.", ""))
            for p, t in _leaves(spec)}
    theirs = {p: (tuple(t.shape), str(t.dtype)) for p, t in _leaves(jspec)}
    assert mine == theirs
    assert sum(int(np.prod(s)) for s, _ in mine.values()) == N_PARAMS[arch]


def card_parity_setup_gap(arch, seed=0):
    """chip_smoke.py's card-vs-CPU serving check (weights drawn on the CPU
    from a torch Generator seeded ``seed``, 4 prompts of 40 positions, 24
    greedy steps) run by the port and by JAX, both on the CPU: (the worst
    gap over the prefill's and every decode step's logits, tokens equal)."""
    jcfg, cfg = _cfgs(arch)
    params = LM(cfg, device="cpu").init(torch.Generator().manual_seed(seed))
    jparams = jax.tree.map(jnp.asarray, convert.lm_params_to_numpy(params))
    text = 40 - (cfg.num_patches if cfg.vision else 0)
    batch, _ = _prompt(cfg, 4, text, seed)
    runs = []
    for engine in (Engine(cfg, params, max_seq=64, device="cpu"),
                   JaxEngine(jcfg, jparams, max_seq=64)):
        logits, prefill, decode = [], engine._prefill, engine._decode

        def rec_prefill(p, b, f=prefill, out=logits):
            cache, lg = f(p, b)
            out.append(np.asarray(lg))
            return cache, lg

        def rec_decode(p, c, b, f=decode, out=logits):
            lg, c = f(p, c, b)
            out.append(np.asarray(lg))
            return lg, c
        engine._prefill, engine._decode = rec_prefill, rec_decode
        runs.append((engine.generate(batch, steps=24), logits))
    (tok, got), (jtok, want) = runs
    return max(_rel(g, w) for g, w in zip(got, want)), np.array_equal(
        tok, jtok)


if __name__ == "__main__":
    for arch in ARCHS:
        m = _models(arch)
        logit_gap, gaps = _prefill_gaps(m)
        print(f"{arch} prefill: logits {logit_gap:.3e}, worst cache leaf "
              f"{max(gaps.values()):.3e} ({max(gaps, key=gaps.get)})")
        logit_gap, gaps = _decode_gaps(m)
        print(f"{arch} teacher-forced decode: logits {logit_gap:.3e}, worst "
              f"cache leaf {max(gaps.values()):.3e}")
        ref = _train_ref(arch)
        loss_gap, grads = loss_gaps(ref)
        worst = max(grads, key=grads.get)
        print(f"{arch} loss {loss_gap:.3e}, worst gradient "
              f"{grads[worst]:.3e} ({worst})")
        gaps = train_gaps(ref)
        print(f"{arch} 3 train steps: " + ", ".join(
            f"{k} {max(g[k] for g in gaps):.3e}" for k in RTOL_STEP))
    for kind in ("mlstm", "slstm"):
        for S in (12, 64, 128, 130):
            y_gap, s_gap = xlstm_block_gaps(kind, S)
            print(f"{kind}_block S={S}: out {y_gap:.3e}, states {s_gap:.3e}")
    print(f"cross_attn_block: float32 {cross_attn_gap():.3e}, bf16 "
          f"{cross_attn_gap(jnp.bfloat16):.3e}")
    for arch in ARCHS:
        gap, same = card_parity_setup_gap(arch)
        print(f"{arch} card parity setup, port vs JAX on the CPU: logits "
              f"{gap:.3e}, tokens equal {same}")
