"""Opt-in runtime sanitizer: NaN and index checks on the numeric entry points.

The port's counterpart of the JAX package's checkify shim. ``wrap(fn)``
runs ``fn`` under a ``TorchDispatchMode``, which sees every aten op that
``fn`` dispatches, as checkify sees every primitive:

- **index check**: before an indexing op runs (``index``, ``index_put``,
  ``gather``, ``index_select``, ``embedding``, ``scatter*``, ...), its
  integer index operand is held against the extent it indexes; one host
  sync per op, *before* the launch, so an out-of-range index raises an
  ``IndexError`` ("out-of-bounds ...") on the host instead of a device-side
  assert that would poison the CUDA context for the rest of the process.
- **NaN check**: after an op runs, a flag records whether a floating
  output holds a NaN that none of its floating inputs held. The flags stay
  on the device; when ``fn`` returns, one sync per device finds the first
  op that flagged, and ``FloatingPointError`` names it ("nan generated by
  aten.log.default"). Ops that allocate without writing (``empty``...),
  views, and ops that only move or select values (copies, ``cat``,
  ``where``, gathers) cannot make a NaN and are not checked.

The CUDA kernels launch through ``ctypes`` and are invisible to a dispatch
mode, so their wrappers call ``check_kernel`` on their own outputs while a
``wrap`` is active (a NaN out of non-NaN inputs names the kernel).

Three switches, innermost wins:

  ``REPRO_SANITIZE=1``            process-wide
  ``enabled_scope(on)``           a block (``Compiler(sanitize=True)``)
  ``enabled(explicit=...)``       one call

Off (the default) the wired entry points call the plain functions untouched:
no dispatch mode, no added launch or host sync, bit-identical results. On,
the outputs are bit-identical too (the checks only read), at the cost of a
few reductions per op and one host sync per indexing op.
"""
from __future__ import annotations

import contextlib
import functools
import math
import os
from typing import List, Optional

import torch
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _disable_current_modes)

_FORCED: List[bool] = []     # enabled_scope() overrides, innermost last
_ACTIVE: List["_Checks"] = []  # the modes of the wrap() calls running now

aten = torch.ops.aten

# allocate without writing: their garbage may hold NaN bit patterns
_UNWRITTEN = {aten.empty, aten.empty_like, aten.empty_strided,
              aten.new_empty, aten.new_empty_strided}
# move or select values, never compute one: a NaN in their output was in
# an input
_MOVES = {aten._to_copy, aten.copy_, aten.clone, aten.cat, aten.stack,
          aten.index, aten.gather, aten.index_select, aten.embedding,
          aten.where, aten.lift_fresh, aten.lift_fresh_copy, aten.detach,
          aten.flip, aten.repeat, aten.zero_}
# indexing ops whose index operand indexes one dim of their first argument
_DIM_INDEXED = {aten.gather, aten.index_select, aten.scatter, aten.scatter_,
                aten.scatter_add, aten.scatter_add_, aten.scatter_reduce,
                aten.scatter_reduce_, aten.index_add, aten.index_add_,
                aten.index_copy, aten.index_copy_, aten.index_fill,
                aten.index_fill_}
# indexing ops with a list of per-dim index operands
_LIST_INDEXED = {aten.index, aten.index_put, aten.index_put_,
                 aten._index_put_impl_}
_INDEXING = _DIM_INDEXED | _LIST_INDEXED | {aten.embedding, aten.take}
_MUTATES = {}                # op overload -> does it write an argument?


def _mutates(func) -> bool:
    hit = _MUTATES.get(func)
    if hit is None:
        hit = _MUTATES[func] = any(
            a.alias_info is not None and a.alias_info.is_write
            for a in func._schema.arguments)
    return hit


def enabled(explicit: Optional[bool] = None) -> bool:
    """Is the sanitizer on? ``explicit`` beats scopes beats the env var."""
    if explicit is not None:
        return bool(explicit)
    if _FORCED:
        return _FORCED[-1]
    return os.environ.get("REPRO_SANITIZE") == "1"


@contextlib.contextmanager
def enabled_scope(on: bool = True):
    """Force the sanitizer on/off inside the block (nests; innermost wins)."""
    _FORCED.append(bool(on))
    try:
        yield
    finally:
        _FORCED.pop()


def _leaves(tree):
    if isinstance(tree, (list, tuple)):
        for x in tree:
            yield from _leaves(x)
    elif isinstance(tree, dict):
        for x in tree.values():
            yield from _leaves(x)
    else:
        yield tree


def _tensors(tree):
    return [x for x in _leaves(tree) if isinstance(x, torch.Tensor)]


def _has_nan(ts) -> Optional[torch.Tensor]:
    """A device bool: does any floating tensor of ``ts`` hold a NaN?"""
    flags = [torch.isnan(t).any() for t in ts
             if t.is_floating_point() and t.numel()]
    if not flags:
        return None
    return flags[0] if len(flags) == 1 else torch.stack(flags).any()


def _index_ranges(packet, args, kwargs):
    """(index tensor, lowest allowed, one past the highest, dim) for every
    integer index operand of an indexing op."""
    if packet in _DIM_INDEXED:
        self = args[0]
        dim = args[1] if len(args) > 1 else kwargs["dim"]
        index = args[2] if len(args) > 2 else kwargs["index"]
        n = self.shape[dim] if self.dim() else 1
        return [(index, 0, n, dim)]
    if packet is aten.embedding:
        return [(args[1], 0, args[0].shape[0], 0)]
    if packet is aten.take:
        return [(args[1], -args[0].numel(), args[0].numel(), None)]
    self, indices = args[0], args[1]
    out, dim = [], 0
    for index in indices:
        if index is None:
            dim += 1
            continue
        if index.dtype in (torch.bool, torch.uint8):
            dim += index.dim()      # a mask: its shape is checked by torch
            continue
        n = self.shape[dim]
        out.append((index, -n, n, dim))
        dim += 1
    return out


def _check_index(func, args, kwargs) -> None:
    ranges = [r for r in _index_ranges(func.overloadpacket, args, kwargs)
              if r[0].numel()]
    if not ranges:
        return
    # every operand's (min, max) in one copy to the host: one sync
    extrema = torch.stack([torch.stack([r[0].min(), r[0].max()]).to(
        device=ranges[0][0].device, dtype=torch.int64) for r in ranges])
    for (_, lo, hi, dim), (mn, mx) in zip(ranges, extrema.tolist()):
        if mn < lo or mx >= hi:
            raise IndexError(
                f"out-of-bounds index in {func}: indices span [{mn}, {mx}] "
                f"against [{lo}, {hi}) of dim {dim}")


class _Checks(TorchDispatchMode):
    """The dispatch mode of one ``wrap`` call: index checks before each
    indexing op, NaN flags after each computing op, kept on the device."""

    def __init__(self):
        super().__init__()
        self.flags = []          # (what, device bool tensor), in op order

    def record(self, what, inputs, outputs, in_nan=None) -> None:
        out_nan = _has_nan(outputs)
        if out_nan is None:
            return
        if in_nan is None:
            in_nan = _has_nan(inputs)
        self.flags.append((what, out_nan if in_nan is None
                           else out_nan & ~in_nan))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        packet = func.overloadpacket
        if packet in _INDEXING:
            _check_index(func, args, kwargs)
        if func.is_view or packet in _UNWRITTEN or packet in _MOVES:
            return func(*args, **kwargs)
        operands = list(_leaves((args, {k: v for k, v in kwargs.items()
                                        if k != "out"})))
        if any(isinstance(x, float) and math.isnan(x) for x in operands):
            return func(*args, **kwargs)        # a NaN given as a scalar
        inputs = [x for x in operands if isinstance(x, torch.Tensor)]
        # an op that writes an input reads it first: take its flag before
        in_nan = _has_nan(inputs) if _mutates(func) else None
        out = func(*args, **kwargs)
        self.record(func, inputs, _tensors(out), in_nan)
        return out

    def raise_first(self) -> None:
        """Find the first flagged op (one sync per device) and raise."""
        by_device = {}
        for order, (_, flag) in enumerate(self.flags):
            by_device.setdefault(flag.device, []).append((order, flag))
        first = None
        for entries in by_device.values():
            hit = torch.stack([f for _, f in entries]).nonzero()
            if hit.numel():
                order = entries[int(hit[0, 0])][0]
                first = order if first is None else min(first, order)
        if first is not None:
            raise FloatingPointError(
                f"nan generated by {self.flags[first][0]} "
                f"(op {first} of {len(self.flags)} checked)")


def check_kernel(name: str, inputs, outputs) -> None:
    """Called by a CUDA kernel's wrapper after its launch: while a ``wrap``
    is running, flag a NaN in ``outputs`` that none of ``inputs`` held
    (checked when the ``wrap`` returns). A no-op otherwise."""
    if not _ACTIVE:
        return
    with _disable_current_modes():
        _ACTIVE[-1].record(f"kernel {name}", list(inputs), list(outputs))


def wrap(fn):
    """Run ``fn`` under the NaN and index checks; raise on the first hit.

    The wrapper keeps ``fn``'s signature and return value. An out-of-range
    index raises ``IndexError`` before its op launches; a made NaN raises
    ``FloatingPointError`` naming the first op (or kernel) that made one,
    once ``fn`` has returned.
    """
    @functools.wraps(fn)
    def sanitized(*args, **kwargs):
        mode = _Checks()
        _ACTIVE.append(mode)
        try:
            with mode:
                out = fn(*args, **kwargs)
        finally:
            _ACTIVE.pop()
        with _disable_current_modes():
            mode.raise_first()
        return out

    sanitized.__sanitized__ = True
    return sanitized


def maybe_wrap(fn, explicit: Optional[bool] = None):
    """``wrap(fn)`` when the sanitizer is enabled, else ``fn`` unchanged."""
    return wrap(fn) if enabled(explicit) else fn
