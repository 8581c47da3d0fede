"""Device-parallel evaluation of batched grids (1D and 2D blocks).

``shard_leading`` runs a batched pure function with its first argument's
leading axis split into one block per device; the remaining arguments are
replicated onto each block's device. The grid is padded to a device-count
multiple and un-padded on the way out, so callers never see the device
count. With one device the call is a plain ``fn(x, *rest)``; either way the
result is bit-identical (the same row-independent tensor code, only the
placement differs), which is what lets the hetero composition tests assert
sharded == single-device.

``shard2d`` generalizes this to a 2D block grid for doubly-batched work
(e.g. compositions × operating corners): the first argument's leading axis
splits over one grid axis and the second argument's over the other, with
the device count factorized between them. Same contract: padded in,
un-padded out, bit-identical to the unsharded call.

The JAX package maps these onto a device mesh with ``shard_map``; here the
counterpart is single-process dispatch: each block's call is issued on its
device from this process, one after the other (CUDA launches are
asynchronous, so blocks on different cards overlap), and the outputs are
gathered onto the first device. A device list may repeat a device: its
blocks then run on it in turn, which exercises the multi-block path on a
one-device host (``["cpu"] * k`` in the tests, ``[cuda:0] * k`` on the
card).
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from repro_torch import obs

GRID_AXIS = "grid"
CORNER_AXIS = "corner"

# multi-device dispatches (repro_torch.obs registry); single-device calls
# take the plain-call fast path and are deliberately not counted as
# "sharded"
_C_SHARD = obs.counter("parallel.shard_calls")


def _tree_map(fn, tree):
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return tree


def _leaves(tree) -> List[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _leaves(v)]
    return []


def _devices(devices: Optional[Sequence], like: torch.Tensor
             ) -> List[torch.device]:
    """``devices`` as torch devices; None = every visible CUDA device when
    ``like`` lies on one, else ``like``'s own device."""
    if devices is not None:
        return [torch.device(d) for d in devices]
    if like.device.type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [like.device]


def pad_to_multiple(x: torch.Tensor, multiple: int):
    """Pad ``x``'s leading axis up to a multiple of ``multiple`` by repeating
    its first row (values are discarded by the caller's un-pad slice).

    Returns ``(padded, original_length)``."""
    n = x.shape[0]
    if multiple <= 1 or n % multiple == 0:
        return x, n
    pad = multiple - n % multiple
    fill = x[:1].expand((pad,) + tuple(x.shape[1:]))
    return torch.cat([x, fill], dim=0), n


def _blocks(tree, ways: int):
    """Pad every leaf of ``tree`` to a ``ways`` multiple and cut it into
    ``ways`` equal leading-axis blocks: a list of ``ways`` trees."""
    padded = _tree_map(lambda leaf: pad_to_multiple(leaf, ways)[0], tree)
    return [_tree_map(lambda leaf, i=i: leaf.chunk(ways)[i], padded)
            for i in range(ways)]


def _to(tree, dev: torch.device):
    return _tree_map(lambda leaf: leaf.to(dev), tree)


def shard_leading(fn, x, *rest, devices: Optional[Sequence] = None,
                  axis_name: str = GRID_AXIS):
    """Evaluate ``fn(x, *rest)`` with ``x``'s leading axis split over
    ``devices``.

    ``fn``     pure, shape-polymorphic over the leading axis of ``x``; every
               output leaf must carry that leading axis.
    ``x``      the grid tensor, shape ``(J, ...)``.
    ``rest``   broadcast (replicated) arguments — tensors or trees of them.
    ``devices`` defaults to every visible CUDA device (``x``'s own device
               when that is the CPU); with one device the call is a plain
               ``fn(x, *rest)``.
    ``axis_name`` names the split axis (the JAX mesh's axis name; kept for
               the same signature).

    Returns ``fn``'s output with every leaf un-padded back to length ``J``,
    gathered onto the first device.
    """
    devs = _devices(devices, x)
    n_dev = len(devs)
    if n_dev <= 1:
        return fn(x, *rest)
    with obs.span("parallel.shard", mesh="1d", n_dev=n_dev):
        _C_SHARD.inc()
        n = x.shape[0]
        outs = [fn(block.to(dev), *_to(rest, dev))
                for block, dev in zip(_blocks(x, n_dev), devs)]
        return _gather1d(outs, devs[0], n)


def _gather1d(outs, dev: torch.device, n: int):
    """Concatenate the blocks' output trees along the leading axis on
    ``dev`` and un-pad to ``n``."""
    head = outs[0]
    if isinstance(head, torch.Tensor):
        return torch.cat([o.to(dev) for o in outs], dim=0)[:n]
    if isinstance(head, dict):
        return {k: _gather1d([o[k] for o in outs], dev, n) for k in head}
    return type(head)(_gather1d([o[i] for o in outs], dev, n)
                      for i in range(len(head)))


def _factor_devices(n_dev: int, minor_n: int) -> Tuple[int, int]:
    """Split ``n_dev`` into ``(major_ways, minor_ways)``: the minor axis gets
    the largest divisor of ``n_dev`` not exceeding its extent ``minor_n`` (no
    point cutting a 2-corner axis 8 ways), the major axis the rest."""
    minor_ways = max(d for d in range(1, n_dev + 1)
                     if n_dev % d == 0 and d <= max(minor_n, 1))
    return n_dev // minor_ways, minor_ways


def _gather2d(outs, dev: torch.device, n_y: int, n_x: int):
    """Assemble ``outs[i][j]`` (x block i, y block j; leaves ``(y_blk,
    x_blk, ...)``) into whole ``(n_y, n_x, ...)`` leaves on ``dev``."""
    head = outs[0][0]
    if isinstance(head, torch.Tensor):
        rows = [torch.cat([outs[i][j].to(dev) for i in range(len(outs))],
                          dim=1) for j in range(len(outs[0]))]
        return torch.cat(rows, dim=0)[:n_y, :n_x]
    if isinstance(head, dict):
        return {k: _gather2d([[o[k] for o in row] for row in outs], dev,
                             n_y, n_x) for k in head}
    return type(head)(_gather2d([[o[i] for o in row] for row in outs], dev,
                                n_y, n_x) for i in range(len(head)))


def shard2d(fn, x, y, *rest, devices: Optional[Sequence] = None,
            axis_names: Tuple[str, str] = (GRID_AXIS, CORNER_AXIS)):
    """Evaluate ``fn(x, y, *rest)`` on a 2D grid of blocks over ``devices``.

    ``fn``     pure; shape-polymorphic over the leading axis of every ``x``
               leaf and of every ``y`` leaf; every output leaf must carry
               ``(y_leading, x_leading)`` as its first two axes.
    ``x``      tensor or tree whose leaves share leading extent ``J`` —
               split over the grid's first axis (``axis_names[0]``).
    ``y``      tensor or tree whose leaves share leading extent ``C`` —
               split over its second axis (``axis_names[1]``).
    ``rest``   broadcast (replicated) arguments.
    ``devices`` defaults as in ``shard_leading``; the device count
               factorizes across the two axes (minor ``y`` axis first,
               capped at ``C``), device ``i * ways_y + j`` taking x block
               ``i`` and y block ``j`` (the JAX mesh's row-major order);
               with one device the call is a plain ``fn(x, y, *rest)``.

    Both leading axes are padded to block-count multiples and un-padded on
    the way out, so results are bit-identical to the unsharded call.
    """
    devs = _devices(devices, _leaves(x)[0])
    n_dev = len(devs)
    if n_dev <= 1:
        return fn(x, y, *rest)
    with obs.span("parallel.shard", mesh="2d", n_dev=n_dev):
        _C_SHARD.inc()
        n_x = _leaves(x)[0].shape[0]
        n_y = _leaves(y)[0].shape[0]
        ways_x, ways_y = _factor_devices(n_dev, n_y)
        x_blocks, y_blocks = _blocks(x, ways_x), _blocks(y, ways_y)

        def block(i: int, j: int):
            dev = devs[i * ways_y + j]
            return fn(_to(x_blocks[i], dev), _to(y_blocks[j], dev),
                      *_to(rest, dev))
        outs = [[block(i, j) for j in range(ways_y)] for i in range(ways_x)]
        return _gather2d(outs, devs[0], n_y, n_x)
