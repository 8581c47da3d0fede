"""The checks that hold the port's sharded paths to one process, run
inside the workers of ``repro_torch.launch.spmd.launch`` on every rank, by
``tests/test_torch_sharding.py`` (gloo on the CPU), ``tests/test_torch_cuda
.py`` and ``chip_smoke.py``'s phase 32 (NCCL on the cards). Each builds its
own mesh over the started processes (``launch.mesh.make_mesh``):
- ``train_check``: the sharded train step (``train.step`` with ``mesh=``)
  against the same steps on one device, or its times alone;
- ``moe_check``: the expert-parallel MoE block, its outputs, load and
  gradients;
- ``ef_int8_check``: ``parallel.compression.ef_int8_psum_mean`` over the
  ranks, and ``compressed_grad_check``: ``make_compressed_grad_fn`` over
  a ``make_host_mesh``;
- ``reshard_check``: a checkpoint written on one mesh restored on others;
- ``supervised_check``: a supervised sharded run with a failure injected,
  against one without;
- ``collectives_check``: the collectives one sharded train step makes,
  as a hook on ``torch.distributed`` sees them (what the dry run's
  recorder is held to).
"""
from __future__ import annotations

import math
import os
import time
from typing import Any, Dict

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.optim.adamw import leaves


# ---------------------------------------------------------------------------
# helpers inside a worker
# ---------------------------------------------------------------------------


def _device() -> torch.device:
    return torch.device("cuda", torch.cuda.current_device()) \
        if dist.get_backend() == "nccl" else torch.device("cpu")


def _mesh(shape, axes=("data", "model")):
    from repro_torch.launch.mesh import make_mesh
    return make_mesh(tuple(shape), tuple(axes),
                     "cuda" if _device().type == "cuda" else "cpu")


def _config(spec):
    from repro_torch.configs import get_config, reduce_config
    cfg = get_config(spec["arch"])
    if spec.get("reduced"):
        cfg = reduce_config(cfg)
    return cfg.replace(**spec.get("overrides", {}))


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _numpy_tree(tree) -> Dict[str, np.ndarray]:
    """{path joined with "|": float64 array} of a tree of tensors."""
    from repro_torch.parallel.sharding import flatten_with_path
    return {"|".join(map(str, k)): v.detach().double().cpu().numpy()
            for k, v in flatten_with_path(tree)}


def _state_numpy(params, opt) -> Dict[str, Dict[str, np.ndarray]]:
    return {"params": _numpy_tree(params), "m": _numpy_tree(opt["m"]),
            "v": _numpy_tree(opt["v"])}


def _state(params, opt):
    return {"params": params, "m": opt["m"], "v": opt["v"]}


# the entries of a leaf compared at a time, so that the float64 copies of
# a full-width leaf (deepseek-v3's 926.7 M-entry embedding) never sit on a
# card beside a float32 training state
_CHUNK = 1 << 26


def _chunks(*leaves_):
    """Matching flat slices of same-shaped tensors, ``_CHUNK`` entries at
    a time, together on one device: the card if one of them is on it."""
    flat = [t.reshape(-1) for t in leaves_]
    for i in range(0, flat[0].numel(), _CHUNK):
        parts = [t[i:i + _CHUNK] for t in flat]
        dev = next((p.device for p in parts if p.device.type == "cuda"),
                   parts[0].device)
        yield [p.to(dev) for p in parts]


@torch.no_grad()
def _state_gaps(got, want):
    """Per part (params, m, v): the largest over the leaves of max|got -
    want| / max|want|, on the device, and the leaf that has it
    (``worst``); and whether every leaf is equal."""
    from repro_torch.parallel.sharding import flatten_with_path
    gaps, worst, equal = {}, {}, True
    for part in want:
        gaps[part], worst[part] = 0.0, None
        for (path, a), (_, b) in zip(flatten_with_path(got[part]),
                                     flatten_with_path(want[part])):
            num = den = 0.0
            for ca, cb in _chunks(a, b):
                equal = equal and torch.equal(ca, cb)
                num = max(num, float((ca.double() - cb.double()).abs().max()))
                den = max(den, float(cb.double().abs().max()))
            gap = num / den if den else (0.0 if num == 0 else math.inf)
            if gap > gaps[part]:
                gaps[part], worst[part] = gap, "/".join(map(str, path))
    gaps["worst"] = worst
    return gaps, equal


# the update check's entries: those whose first moment is at least this
# share of its leaf's largest (well above the moments' reorder noise,
# which RTOL_GRAD bounds at 2e-3 of it)
UPDATE_M_SHARE = 1e-2
_MANTISSA = {torch.float32: 23, torch.bfloat16: 7, torch.float16: 10,
             torch.float64: 52}


@torch.no_grad()
def _update_gaps(got, want, lr):
    """The parameters ``got`` against ``want`` after a step at ``lr`` > 0
    from the same parameters and moments whose first moments ``want["m"]``
    are (plain, not int8), in units of lr, one ulp of the leaf's dtype
    forgiven: ``update``, the largest over the entries whose |m| is at
    least ``UPDATE_M_SHARE`` of their leaf's largest (their AdamW
    direction is fixed by the gradient, not by its rounding); ``flips``,
    the share of all entries apart by more than lr / 10 (directions of
    moments near zero, which a reordered sum may turn)."""
    worst, flipped, total = 0.0, 0, 0
    for a, b, m in zip(leaves(got["params"]), leaves(want["params"]),
                       leaves(want["m"])):
        if not b.numel():
            continue
        bits = _MANTISSA[b.dtype]
        total += b.numel()
        m_max = max(float(c.abs().max()) for (c,) in _chunks(m))
        for ca, cb, cm in _chunks(a, b, m):
            ca, cb = ca.double(), cb.double()
            _, e = torch.frexp(torch.maximum(ca.abs(), cb.abs())
                               .clamp_min(1e-30))
            ulp = torch.ldexp(torch.ones_like(cb), e - 1 - bits)
            d = ((ca - cb).abs() - ulp).clamp_min(0) / lr
            big = cm.double().abs() >= UPDATE_M_SHARE * m_max
            if bool(big.any()):
                worst = max(worst, float(d[big].max()))
            flipped += int((d > 0.1).sum())
    return {"update": worst, "flips": flipped / max(total, 1)}


def _kernel_counters():
    from repro_torch.kernels import flash_attention as kflash
    from repro_torch.kernels import ssm_scan as kssm
    return {"flash_attention": kflash.flash_attention,
            "flash_attention_bwd": kflash.flash_attention_bwd,
            "ssm_scan": kssm.ssm_scan, "ssm_scan_bwd": kssm.ssm_scan_bwd}


def _run_steps(step, params, opt, data, stepnos, dev):
    """``step`` at each of ``stepnos`` on ``data``'s next batches. Returns
    (params, opt, rows: loss, grad_norm, lr, seconds, launches)."""
    counters = _kernel_counters()
    rows = []
    for i in stepnos:
        batch = data.next_batch()
        before = {k: f.launches for k, f in counters.items()}
        _sync(dev)
        t0 = time.perf_counter()
        params, opt, m = step(params, opt, batch, i)
        loss, gnorm = float(m["loss"]), float(m["grad_norm"])
        _sync(dev)
        rows.append({"loss": loss, "grad_norm": gnorm, "lr": float(m["lr"]),
                     "s": time.perf_counter() - t0,
                     "launches": {k: f.launches - before[k]
                                  for k, f in counters.items()}})
        if not (np.isfinite(loss) and np.isfinite(gnorm)):
            raise FloatingPointError(f"step {i}: loss {loss}, grad_norm "
                                     f"{gnorm}")
    return params, opt, rows


def _nccl_share(step, params, opt, batch, stepno, dev):
    """A profiled step on this rank: (params, opt, wall seconds, device ms,
    the share of the device time in NCCL kernels)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        params, opt, _ = step(params, opt, batch, stepno)
        _sync(dev)
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    nccl = sum(e.self_device_time_total for e in kernels
               if "nccl" in e.key.lower()) / 1e3
    return params, opt, wall, busy, (nccl / busy if busy else None)


# ---------------------------------------------------------------------------
# the checks
# ---------------------------------------------------------------------------


def _step_gaps(rows, state, rows1, state1, acfg):
    """The gaps of the steps ``rows`` ending in ``state`` to ``rows1``
    ending in ``state1``: loss and grad_norm relative (the largest over the
    steps), lr absolute, ``_state_gaps``' per part, and after a last step
    at lr > 0 with plain moments ``_update_gaps``'."""
    gaps, equal = _state_gaps(state, state1)
    out = {"loss": max(abs(a["loss"] - b["loss"]) / abs(b["loss"])
                       for a, b in zip(rows, rows1)),
           "grad_norm": max(abs(a["grad_norm"] - b["grad_norm"])
                            / abs(b["grad_norm"])
                            for a, b in zip(rows, rows1)),
           "lr": max(abs(a["lr"] - b["lr"]) for a, b in zip(rows, rows1)),
           **gaps,
           "bit_equal": equal and all(a["loss"] == b["loss"]
                                      and a["grad_norm"] == b["grad_norm"]
                                      for a, b in zip(rows, rows1))}
    lr = rows1[-1]["lr"]
    if lr > 0 and not acfg.quantized:
        out.update(_update_gaps(state, state1, lr))
    return out


def train_check(spec: Dict[str, Any]):
    """The sharded train step of ``spec`` on every rank. ``spec``: arch,
    reduced, overrides (config fields), mesh (D, M), batch, seq,
    data_seed, seed (weights) or np_params (the weights, numpy), base_lr,
    warmup, total_steps, remat, quantized (int8 AdamW moments), env
    (variables set for the run), steps
    (the step numbers compared), warm (the steps timed after them). With
    ``trees``, rank 0 returns the gathered parameters and moments after
    the compared steps; with ``single``, rank 0 runs the compared steps on
    one device at the end and returns the gaps (``_step_gaps``), and with
    ``noise`` as well, those of one device's same steps in 2 microbatches
    to its whole-batch ones (``noise_gaps``); with ``profile``, one more
    step is profiled on rank 0 (NCCL's share of the device time). Rank 0
    returns the rows of every step (launches of the model's kernels,
    seconds), each rank's peak memory over the warm steps and the
    mesh."""
    from repro_torch.data.pipeline import SyntheticLMData
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.parallel.sharding import full_tensor, map_tree
    from repro_torch.train.step import (init_train_state, make_train_step,
                                        place_train_state)
    dev = _device()
    acfg = AdamWConfig(quantized=spec.get("quantized", False))
    cfg = _config(spec)
    mesh = _mesh(spec["mesh"])
    saved_env = {k: os.environ.get(k) for k in spec.get("env", {})}
    os.environ.update(spec.get("env", {}))

    def fresh(mesh):
        if "np_params" in spec:
            from repro_torch import convert
            return place_train_state(convert.lm_params_from_numpy(
                cfg, spec["np_params"], device=dev), acfg, mesh)
        return init_train_state(
            cfg, torch.Generator(device=dev).manual_seed(spec.get("seed", 0)),
            acfg, device=dev, mesh=mesh)

    def host(tree):         # gathered leaf by leaf onto the host
        return map_tree(lambda t: full_tensor(t).to("cpu", copy=True), tree)
    try:
        kw = dict(base_lr=spec.get("base_lr", 1e-3),
                  warmup=spec.get("warmup", 200),
                  total_steps=spec.get("total_steps", 10_000),
                  remat=spec.get("remat", "full"), acfg=acfg)
        steps = list(spec.get("steps", [0]))
        t0 = time.perf_counter()
        _, step = make_train_step(cfg, device=dev, mesh=mesh, **kw)
        params, opt = fresh(mesh)
        _sync(dev)
        init_s = time.perf_counter() - t0
        n_params = sum(int(math.prod(t.shape)) for t in leaves(params))
        data = SyntheticLMData(cfg, spec["batch"], spec["seq"],
                               spec.get("data_seed", 0))
        params, opt, rows = _run_steps(step, params, opt, data, steps, dev)
        full = None
        if spec.get("trees") or spec.get("single"):
            with torch.no_grad():
                full = _state(host(params), host(opt))
            if dist.get_rank() != 0:
                full = None
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        warm = [steps[-1] + 1 + i for i in range(spec.get("warm", 0))]
        params, opt, warm_rows = _run_steps(step, params, opt, data, warm,
                                            dev)
        out: Dict[str, Any] = {"mesh": tuple(mesh.shape),
                               "axes": tuple(mesh.mesh_dim_names),
                               "world": dist.get_world_size(),
                               "params": n_params, "init_s": init_s,
                               "rows": rows, "warm_rows": warm_rows}
        if spec.get("profile"):
            batch = data.next_batch()
            nxt = (warm or steps)[-1] + 1
            if dist.get_rank() == 0:
                params, opt, wall, busy, share = _nccl_share(
                    step, params, opt, batch, nxt, dev)
                out["profile"] = {"wall_s": wall, "device_ms": busy,
                                  "nccl_share": share}
            else:
                params, opt, _ = step(params, opt, batch, nxt)
        peak = torch.cuda.max_memory_allocated(dev) \
            if dev.type == "cuda" else 0
        peaks = [None] * dist.get_world_size()
        dist.all_gather_object(peaks, peak)
        out["peak_bytes"] = peaks
        del params, opt, step
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        if dist.get_rank() != 0:
            dist.barrier()
            return None
        if spec.get("trees"):
            out["state"] = {k: _numpy_tree(v) for k, v in full.items()}
        if spec.get("single"):
            # the same steps on one device; with ``noise``, again with the
            # batch in 2 microbatches: one device's own reorder of its sums
            ref = None
            for micro in ([None, spec["batch"] // 2] if spec.get("noise")
                          else [None]):
                _, step1 = make_train_step(cfg, device=dev,
                                           microbatch=micro, **kw)
                p1, o1 = fresh(None)
                data1 = SyntheticLMData(cfg, spec["batch"], spec["seq"],
                                        spec.get("data_seed", 0))
                p1, o1, rows1 = _run_steps(step1, p1, o1, data1, steps, dev)
                if ref is None:
                    out["single_rows"] = rows1
                    out["gaps"] = _step_gaps(rows, full, rows1,
                                             _state(p1, o1), acfg)
                    if spec.get("noise"):
                        ref = (rows1, map_tree(
                            lambda t: t.detach().to("cpu", copy=True),
                            _state(p1, o1)))
                else:
                    out["noise_gaps"] = _step_gaps(rows1, _state(p1, o1),
                                                   *ref, acfg)
                del p1, o1, step1
                if dev.type == "cuda":
                    torch.cuda.empty_cache()
            del full, ref
        dist.barrier()
        return out
    finally:
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


# the torch.distributed collectives the hook of ``collectives_check``
# watches, with the reference's kind names; any other call it sees is
# recorded under its own name
_HOOKED = {"all_reduce": "all-reduce", "all_gather": "all-gather",
           "all_gather_into_tensor": "all-gather",
           "reduce_scatter": "reduce-scatter",
           "reduce_scatter_tensor": "reduce-scatter",
           "all_to_all": "all-to-all", "all_to_all_single": "all-to-all",
           "broadcast": "broadcast", "send": "send", "recv": "recv"}


def _result_bytes(name, args, kwargs) -> int:
    """The bytes of a collective's result on this rank: the output list or
    tensor, else the tensor reduced or sent in place."""
    out = args[0] if args else next(iter(kwargs.values()))
    ts = out if isinstance(out, (list, tuple)) else [out]
    return sum(t.numel() * t.element_size() for t in ts)


def collectives_check(spec: Dict[str, Any]):
    """One sharded train step of ``spec`` (``train_check``'s keys: arch,
    reduced, overrides, mesh, batch, seq, data_seed, seed, quantized, env,
    remat) with every ``torch.distributed`` collective it calls recorded by
    a hook: rank 0 returns {kind: {"count", "bytes"}} (bytes of each
    result on the rank)."""
    from repro_torch.data.pipeline import SyntheticLMData
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.parallel.comm import tally
    from repro_torch.train.step import init_train_state, make_train_step
    dev = _device()
    acfg = AdamWConfig(quantized=spec.get("quantized", False))
    cfg = _config(spec)
    mesh = _mesh(spec["mesh"])
    saved_env = {k: os.environ.get(k) for k in spec.get("env", {})}
    os.environ.update(spec.get("env", {}))
    records, saved = [], {}

    def hooked(name, fn):
        def call(*args, **kwargs):
            records.append((_HOOKED[name], _result_bytes(name, args,
                                                         kwargs)))
            return fn(*args, **kwargs)
        return call
    try:
        _, step = make_train_step(cfg, device=dev, mesh=mesh,
                                  remat=spec.get("remat", "full"), acfg=acfg)
        params, opt = init_train_state(
            cfg, torch.Generator(device=dev).manual_seed(spec.get("seed", 0)),
            acfg, device=dev, mesh=mesh)
        batch = SyntheticLMData(cfg, spec["batch"], spec["seq"],
                                spec.get("data_seed", 0)).next_batch()
        dist.barrier()
        for name, fn in ((n, getattr(dist, n)) for n in _HOOKED):
            saved[name] = fn
            setattr(dist, name, hooked(name, fn))
        try:
            step(params, opt, batch, 0)
        finally:
            for name, fn in saved.items():
                setattr(dist, name, fn)
        dist.barrier()
        return tally(records) if dist.get_rank() == 0 else None
    finally:
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def moe_check(spec: Dict[str, Any]):
    """The MoE block of ``spec["arch"]`` (reduced) under a ``spec["mesh"]``
    mesh, from the parameters ``spec["p"]`` and input ``spec["x"]`` (numpy,
    every rank the same; each rank feeds its data block): rank 0 returns
    the whole y, the load and the gradients of sum(y) (the ranks' summed
    over the data axes). With ``spec["plain"]`` it also returns the
    unsharded block's on this device."""
    from repro_torch.models import moe
    from repro_torch.parallel import comm
    from repro_torch.parallel.sharding import map_tree, use_mesh
    dev = _device()
    cfg = _config(spec)
    mesh = _mesh(spec["mesh"])

    def tensors():
        return map_tree(lambda a: torch.tensor(a, device=dev,
                                               requires_grad=True),
                        spec["p"])
    p = tensors()
    x = torch.tensor(spec["x"], device=dev)
    data = comm.data_axes(mesh)
    with use_mesh(mesh):
        y, aux = moe.moe_block(p, comm.block(x, 0, data, mesh), cfg)
    flat = [t for t in leaves(p) if t.requires_grad]
    grads = torch.autograd.grad(y.float().sum(), flat, allow_unused=True,
                                materialize_grads=True)
    grads = [comm.all_reduce_(g.float(), data, mesh=mesh) for g in grads]
    y = comm.all_gather(y.detach(), 0, data, mesh)
    if dist.get_rank() != 0:
        return None
    it = iter(grads)
    out = {"y": y.double().cpu().numpy(),
           "load": aux["load"].double().cpu().numpy(),
           "grads": _numpy_tree(map_tree(lambda _: next(it), p)),
           "mesh": tuple(mesh.shape)}
    if spec.get("plain"):
        p0 = tensors()
        y0, aux0 = moe._moe_block_plain(p0, x, cfg)
        g0 = torch.autograd.grad(y0.float().sum(), leaves(p0),
                                 allow_unused=True, materialize_grads=True)
        it0 = iter(g0)
        out["plain"] = {"y": y0.detach().double().cpu().numpy(),
                        "load": aux0["load"].double().cpu().numpy(),
                        "grads": _numpy_tree(map_tree(lambda _: next(it0),
                                                      p0))}
    return out


def ef_int8_check(spec: Dict[str, Any]):
    """``ef_int8_psum_mean`` over every rank, twice (the second step
    carrying the first's residuals): each rank returns its int8 payload
    and scale, the mean and the residuals of both steps.
    ``spec["g"][rank]`` holds each rank's two gradient trees (numpy)."""
    from repro_torch.parallel import compression
    from repro_torch.optim.adamw import tree_map as map_tree
    dev = _device()
    rank = dist.get_rank()
    resid = None
    out = []
    for g_np in spec["g"][rank]:
        g = map_tree(lambda a: torch.tensor(a, device=dev), g_np)
        if resid is None:
            resid = compression.init_residuals(g)
        x = map_tree(lambda a, r: a.float() + r, g, resid)
        payload = map_tree(lambda t: compression.int8_payload(t, None), x)
        mean, resid = compression.ef_int8_psum_mean(g, resid, None)
        out.append({"q": map_tree(lambda qs: qs[0].cpu().numpy(), payload),
                    "scale": map_tree(lambda qs: float(qs[1]), payload),
                    "mean": map_tree(lambda t: t.cpu().numpy(), mean),
                    "resid": map_tree(lambda t: t.cpu().numpy(), resid)})
    return out


def compressed_grad_check(spec: Dict[str, Any]):
    """``make_compressed_grad_fn`` of a least-squares loss over a
    ``make_host_mesh`` of every rank, ``spec["steps"]`` steps on the same
    global batch (``spec["w"]``, ``spec["x"]``, ``spec["y"]``, numpy): each
    rank returns each step's loss, compressed mean gradient and its
    residual, and the loss and its gradient over the whole batch."""
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.parallel import compression
    dev = _device()
    mesh = make_host_mesh(dev.type)
    w = {"w": torch.tensor(spec["w"], device=dev)}
    batch = {"x": torch.tensor(spec["x"], device=dev),
             "y": torch.tensor(spec["y"], device=dev)}

    def loss_fn(p, b):
        return torch.mean((b["x"] @ p["w"] - b["y"]) ** 2)
    grad_fn = compression.make_compressed_grad_fn(loss_fn, mesh, "data")
    resid = compression.init_residuals(w)
    steps = []
    for _ in range(spec["steps"]):
        loss, g, resid = grad_fn(w, batch, resid)
        steps.append({"loss": float(loss), "g": g["w"].cpu().numpy(),
                      "resid": resid["w"].cpu().numpy()})
    exact = torch.autograd.grad(loss_fn(w, batch), [w["w"]])[0]
    return {"steps": steps, "exact_g": exact.cpu().numpy(),
            "exact_loss": float(loss_fn(w, batch)),
            "mesh": tuple(mesh.shape)}


def reshard_check(spec: Dict[str, Any]):
    """Checkpoints across meshes (``spec``: arch, reduced, overrides,
    mesh, dir, and ``foreign``: a directory holding a checkpoint written
    elsewhere): the sharded state written on ``spec["mesh"]``, then read
    back on it, on a (world,) data mesh and on one device; one written on
    one device read back on the mesh; the foreign one read onto the mesh.
    Rank 0 returns whether each came back bit-equal, and the foreign
    checkpoint's leaves as read on the mesh."""
    from repro_torch.checkpoint.ckpt import Checkpointer
    from repro_torch.parallel.sharding import gather_tree
    from repro_torch.train.step import init_train_state
    dev = _device()
    cfg = _config(spec)
    world = dist.get_world_size()
    mesh = _mesh(spec["mesh"])
    data_mesh = _mesh((world,), ("data",))
    gen = torch.Generator(device=dev).manual_seed(spec.get("seed", 0))
    params, opt = init_train_state(cfg, gen, device=dev, mesh=mesh)
    with torch.no_grad():
        want = _state_numpy(gather_tree(params), gather_tree(opt))
    ck = Checkpointer(os.path.join(spec["dir"], "sharded"), async_write=False)
    ck.save(3, params, opt, {"seed": 0, "step": 3})
    single_p, single_o = init_train_state(
        cfg, torch.Generator(device=dev).manual_seed(spec.get("seed", 0) + 1),
        device=dev)

    def same(p, o, ref):
        got = _state_numpy(gather_tree(p), gather_tree(o)) if hasattr(
            leaves(p)[0], "device_mesh") else _state_numpy(p, o)
        return all(np.array_equal(got[k][n], ref[k][n])
                   for k in ref for n in ref[k])

    res = {}
    for label, m in (("same_mesh", mesh), ("data_mesh", data_mesh)):
        _, p, o, _ = ck.restore(params_template=single_p,
                                opt_template=single_o, mesh=m)
        res[label] = same(p, o, want)
        res[label + "_placed"] = tuple(leaves(p)[0].device_mesh.shape)
    _, p, o, _ = ck.restore(params_template=single_p, opt_template=single_o)
    res["one_device"] = same(p, o, want)
    # one device -> the mesh (the ranks each write a copy of their own)
    ck1 = Checkpointer(os.path.join(spec["dir"], f"single{dist.get_rank()}"),
                       async_write=False)
    ck1.save(1, single_p, single_o, {"seed": 0, "step": 1})
    want1 = _state_numpy(single_p, single_o)
    _, p, o, _ = ck1.restore(params_template=params, opt_template=opt)
    res["to_mesh"] = same(p, o, want1)
    res["to_mesh_placed"] = tuple(leaves(p)[0].device_mesh.shape)
    if spec.get("foreign"):
        fk = Checkpointer(spec["foreign"], async_write=False)
        _, p, o, _ = fk.restore(params_template=single_p,
                                opt_template=single_o, mesh=mesh)
        res["foreign"] = _state_numpy(gather_tree(p), gather_tree(o))
    dist.barrier()
    return res if dist.get_rank() == 0 else None


def supervised_check(spec: Dict[str, Any]):
    """A sharded run of ``spec["steps"]`` steps under the supervisor with a
    failure injected at ``spec["fail_at"]`` (every rank fails there, as a
    lost node fails the whole job), against the same run without: rank 0
    returns the restarts, the losses of both and whether the final states
    are bit-equal."""
    from repro_torch.checkpoint.ckpt import Checkpointer
    from repro_torch.data.pipeline import SyntheticLMData
    from repro_torch.parallel.sharding import gather_tree
    from repro_torch.runtime.supervisor import Supervisor, SupervisorConfig
    from repro_torch.train.step import init_train_state, make_train_step
    dev = _device()
    cfg = _config(spec)
    mesh = _mesh(spec["mesh"])
    runs = []
    for label, fail_at in (("clean", None), ("injected", spec["fail_at"])):
        _, step = make_train_step(cfg, base_lr=1e-3, warmup=2,
                                  total_steps=spec["steps"], device=dev,
                                  mesh=mesh)
        params, opt = init_train_state(
            cfg, torch.Generator(device=dev).manual_seed(0), device=dev,
            mesh=mesh)
        data = SyntheticLMData(cfg, spec["batch"], spec["seq"], seed=3)
        crashed = []

        def inject(i, fail_at=fail_at, crashed=crashed):
            if i == fail_at and not crashed:
                crashed.append(i)
                raise RuntimeError("injected failure")
        sup = Supervisor(step, Checkpointer(
            os.path.join(spec["dir"], label), async_write=False),
            SupervisorConfig(ckpt_every=2, max_restarts=2),
            failure_injector=inject)
        params, opt, report = sup.run(params, opt, data, spec["steps"])
        runs.append((report, _state_numpy(gather_tree(params),
                                          gather_tree(opt))))
    if dist.get_rank() != 0:
        return None
    (r0, s0), (r1, s1) = runs
    return {"restarts": r1.restarts, "losses": (r0.losses, r1.losses),
            "bit_equal": all(np.array_equal(s0[k][n], s1[k][n])
                             for k in s0 for n in s0[k])}


def hint_check(spec: Dict[str, Any]):
    """``hint`` and ``maybe_shard`` on a ``spec["mesh"]`` mesh: a replicated
    ``DTensor`` of ``spec["x"]`` placed by each, and a plain tensor. Rank 0
    returns, per case, the placements and whether the full tensor is
    still ``x``; and whether the plain tensor came back as it was."""
    from torch.distributed.tensor import DTensor, Replicate
    from repro_torch.parallel import sharding as sh
    dev = _device()
    mesh = _mesh(spec["mesh"])
    x = torch.tensor(spec["x"], device=dev)
    n = x.shape[1]
    cases = {"hint_DM": (lambda t: sh.hint(t, "D", "M"), (n, n - 1)),
             "hint_D_": (lambda t: sh.hint(t, "D", None), (n, n - 1)),
             "hint_rank_mismatch": (lambda t: sh.hint(t, "D"), (n,)),
             "maybe_pod_data_model": (lambda t: sh.maybe_shard(
                 t, sh.P(("pod", "data"), "model")), (n,))}
    out = {}
    with sh.use_mesh(mesh):
        for label, (fn, widths) in cases.items():
            for cols in widths:         # a width "model" divides, and not
                t = DTensor.from_local(x[:, :cols].contiguous(), mesh,
                                       [Replicate()] * mesh.ndim,
                                       run_check=False)
                y = fn(t)
                out[f"{label}_{cols}"] = (
                    [repr(pl) for pl in y.placements],
                    bool(torch.equal(sh.full_tensor(y), x[:, :cols])))
        out["plain_is_kept"] = sh.hint(x, "D", "M") is x and \
            sh.maybe_shard(x, sh.P("data", "model")) is x
    return out if dist.get_rank() == 0 else None
