"""Checkpoints: atomic, optionally asynchronous, with the reference's
on-disk layout (``repro/checkpoint/ckpt.py``).

``step_<n>/params.npz`` and ``opt.npz`` hold the path-flattened leaves
(keys joined with ``SEP`` over dict keys and sequence indices, the paths of
the reference's ``_flatten``), ``manifest.json`` the step, the data state,
the time, a SHA-256 of the parameters' bytes (leaves in sorted key order)
and, under ``"bfloat16"``, the keys of each file whose leaves are bfloat16:
numpy has no bfloat16, so they are written as their 16-bit patterns
(uint16), the same bytes the reference's digest reads. A float32
checkpoint is byte-compatible with the reference's both ways. Writes go to
a temporary directory published with ``os.replace``, so a crash mid-write
never corrupts the latest checkpoint; the oldest beyond ``keep`` are
removed. Multi-device resharding on restore (the reference's ``mesh`` and
``shardings``) is not ported (ROADMAP.md, queue 1, item 7): leaves are
restored onto their template's device.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

SEP = "|"


def _items(tree, prefix: Tuple = ()):
    """(path, leaf) pairs: dict keys and sequence indices, as
    ``jax.tree_util.tree_flatten_with_path`` walks a tree."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _items(tree[k], prefix + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, t in enumerate(tree):
            yield from _items(t, prefix + (i,))
    else:
        yield prefix, tree


def _key(path) -> str:
    return SEP.join(str(p) for p in path)


def _flatten(tree) -> Tuple[Dict[str, np.ndarray], List[str]]:
    """({key: host array}, keys stored as bfloat16 bit patterns) of a tree
    of tensors. Every array is a copy, so later in-place updates of the
    tree do not reach a checkpoint being written."""
    out, bf16 = {}, []
    for path, leaf in _items(tree):
        key = _key(path)
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            bf16.append(key)
            out[key] = t.view(torch.int16).numpy().view(np.uint16)
        else:
            out[key] = t.numpy()
    return out, bf16


def _digest(arrays: Dict[str, np.ndarray]) -> str:
    digest = hashlib.sha256()
    for k in sorted(arrays):
        digest.update(arrays[k].tobytes())
    return digest.hexdigest()


def _unflatten_into(template, arrays: Dict[str, np.ndarray], bf16):
    """``template``'s structure (a tree of tensors) with each leaf read from
    ``arrays``, as a tensor of the leaf's dtype on its device."""
    bf16 = set(bf16)

    def build(node, path):
        if isinstance(node, dict):
            return {k: build(node[k], path + (k,)) for k in node}
        if isinstance(node, (list, tuple)):
            return type(node)(build(t, path + (i,))
                              for i, t in enumerate(node))
        key = _key(path)
        arr = np.array(arrays[key])
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16) \
            if key in bf16 else torch.from_numpy(arr)
        return t.to(device=node.device, dtype=node.dtype)
    return build(template, ())


class Checkpointer:
    def __init__(self, directory, keep: int = 3, async_write: bool = True):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self.async_write = async_write
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------------ save
    def save(self, step: int, params, opt_state, data_state: Dict[str, Any],
             block: bool = False):
        params_np, params_bf16 = _flatten(params)
        opt_np, opt_bf16 = _flatten(opt_state)
        self.wait()

        def _write():
            tmp = self.dir / f".tmp_step_{step}"
            final = self.dir / f"step_{step}"
            if tmp.exists():
                shutil.rmtree(tmp)
            tmp.mkdir(parents=True)
            np.savez(tmp / "params.npz", **params_np)
            np.savez(tmp / "opt.npz", **opt_np)
            manifest = {
                "step": step,
                "data_state": data_state,
                "time": time.time(),
                "params_sha256": _digest(params_np),
                "bfloat16": {"params": params_bf16, "opt": opt_bf16},
            }
            (tmp / "manifest.json").write_text(json.dumps(manifest))
            if final.exists():
                shutil.rmtree(final)
            os.replace(tmp, final)                    # atomic publish
            self._gc()

        if self.async_write and not block:
            self._thread = threading.Thread(target=_write, daemon=True)
            self._thread.start()
        else:
            _write()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self):
        steps = sorted(self.steps())
        for s in steps[: -self.keep]:
            shutil.rmtree(self.dir / f"step_{s}", ignore_errors=True)

    # --------------------------------------------------------------- restore
    def steps(self):
        return [int(p.name.split("_")[1]) for p in self.dir.glob("step_*")
                if (p / "manifest.json").exists()]

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return max(steps) if steps else None

    def restore(self, step: Optional[int] = None, *, params_template=None,
                opt_template=None):
        """Returns (step, params, opt_state, data_state). With templates the
        leaves come back in the templates' structure, dtypes and devices;
        without, as {key: numpy array} (bfloat16 leaves as uint16 bit
        patterns)."""
        self.wait()
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        d = self.dir / f"step_{step}"
        manifest = json.loads((d / "manifest.json").read_text())
        params_np = dict(np.load(d / "params.npz"))
        opt_np = dict(np.load(d / "opt.npz"))
        if _digest(params_np) != manifest["params_sha256"]:
            raise IOError(f"checkpoint step_{step} failed checksum")
        bf16 = manifest.get("bfloat16", {})
        params = _unflatten_into(params_template, params_np,
                                 bf16.get("params", ())) \
            if params_template is not None else params_np
        opt = _unflatten_into(opt_template, opt_np, bf16.get("opt", ())) \
            if opt_template is not None else opt_np
        return manifest["step"], params, opt, manifest["data_state"]
