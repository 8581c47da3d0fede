"""Carry the reference's parameter stacks across into the port.

The compiler's state is its physics catalog: the device stack
(``DEVICE_STACK``), the bitcell stack (``stack_bitcells()``) and the
retention time grid, and what it characterizes from them, a
``DesignTable``. The language models' state is their parameter tree
(``LM.init``) and, in training, the AdamW state (``optim.adamw``). These
functions take them as numpy arrays and return the port's objects, so a
caller can check that both packages compute from the same catalog, the
same table, the same weights and the same optimizer state; the
``*_to_numpy`` functions carry the port's weights and state back.
"""
from __future__ import annotations

from typing import Any, Mapping, Optional, Sequence, Type, TypeVar

import numpy as np
import torch

from repro_torch.core.bitcells import BitcellParams
from repro_torch.core.devices import DeviceParams
from repro_torch.device import DeviceLike, resolve_device

P = TypeVar("P", DeviceParams, BitcellParams)


def _tensor(array, field: str, device: torch.device) -> torch.Tensor:
    array = np.asarray(array)
    if array.dtype != np.float32:
        raise TypeError(f"{field}: expected float32, got {array.dtype}")
    return torch.from_numpy(array.copy()).to(device)


def params_from_numpy(cls: Type[P], arrays: Mapping[str, np.ndarray],
                      device: DeviceLike = None) -> P:
    """``cls`` (``DeviceParams`` or ``BitcellParams``) from a mapping of
    field name -> float32 array; the field names must match exactly."""
    if set(arrays) != set(cls._fields):
        raise KeyError(f"{cls.__name__} fields {cls._fields}, got "
                       f"{sorted(arrays)}")
    dev = resolve_device(device)
    return cls(*(_tensor(arrays[f], f, dev) for f in cls._fields))


def time_grid_from_numpy(ts: np.ndarray,
                         device: DeviceLike = None) -> torch.Tensor:
    """The retention time grid (N+1,) float32 as a tensor on ``device``."""
    return _tensor(ts, "ts", resolve_device(device))


def table_from_numpy(axes: Mapping[str, np.ndarray],
                     metrics: Mapping[str, np.ndarray],
                     corners: Optional[Sequence] = None):
    """A port ``api.DesignTable`` from the reference table's columns:
    ``axes`` (the seven config axes, ``table.columns`` restricted to
    ``AXIS_NAMES``), ``metrics`` (float32 columns, ``<metric>@<corner>``
    included) and ``corners`` (OperatingPoints, names or (vdd, temp_k[,
    label]) tuples, in column order; None = nominal). Both packages can
    then compose from the same table. A DesignTable's columns are host
    arrays in both packages, so nothing goes to a device here."""
    from repro_torch.api import DesignTable
    from repro_torch.core.corners import NOMINAL, as_operating_point
    if set(axes) != set(DesignTable.AXIS_NAMES):
        raise KeyError(f"DesignTable axes {DesignTable.AXIS_NAMES}, got "
                       f"{sorted(axes)}")
    for name, col in metrics.items():
        if np.asarray(col).dtype != np.float32:
            raise TypeError(f"metric {name}: expected float32, got "
                            f"{np.asarray(col).dtype}")
    ops = (NOMINAL,) if corners is None else \
        tuple(as_operating_point(c) for c in corners)
    return DesignTable({k: np.array(v) for k, v in axes.items()},
                       {k: np.array(v) for k, v in metrics.items()},
                       corners=ops)


def _lm_tensor(array, path: str, want: torch.Tensor,
               device: torch.device) -> torch.Tensor:
    array = np.asarray(array)
    if array.dtype.name == "bfloat16":     # ml_dtypes' bfloat16, as jax has it
        got_dtype = torch.bfloat16
        t = torch.from_numpy(array.view(np.int16).copy()).view(torch.bfloat16)
    elif array.dtype == np.float32:
        got_dtype = torch.float32
        t = torch.from_numpy(array.copy())
    else:
        raise TypeError(f"{path}: dtype {array.dtype} is neither float32 nor "
                        f"bfloat16")
    if got_dtype != want.dtype:
        raise TypeError(f"{path}: expected {want.dtype}, got {array.dtype}")
    if tuple(array.shape) != tuple(want.shape):
        raise ValueError(f"{path}: expected shape {tuple(want.shape)}, got "
                         f"{tuple(array.shape)}")
    return t.to(device)


def lm_params_from_numpy(cfg, tree: Mapping[str, Any],
                         device: DeviceLike = None):
    """The reference's ``LM(cfg).init(key)`` tree, as nested dicts of numpy
    arrays (segments stacked on a leading layer axis, as ``jax.vmap`` lays
    them out), as the port's parameters on ``device``. Names, shapes and
    dtypes must match the port's ``LM(cfg).init`` exactly: every family's
    leaves (MoE experts, MLA projections, the MTP module), a float32 leaf
    of a bf16 model (the MoE router and routing bias) included."""
    from repro_torch.models import LM
    dev = resolve_device(device)
    spec = LM(cfg, device="meta").init()    # shapes and dtypes, no data

    def walk(node, want, path):
        if isinstance(want, dict):
            if not isinstance(node, Mapping) or set(node) != set(want):
                got = sorted(node) if isinstance(node, Mapping) else type(node)
                raise KeyError(f"{path or 'params'}: expected keys "
                               f"{sorted(want)}, got {got}")
            return {k: walk(node[k], want[k], f"{path}/{k}") for k in want}
        return _lm_tensor(node, path, want, dev)

    return walk(tree, spec, "")


_NP_OF = {torch.float32: np.float32, torch.int8: np.int8,
          torch.int32: np.int32}


def _state_tensor(array, path: str, want: torch.Tensor,
                  device: torch.device) -> torch.Tensor:
    array = np.asarray(array)
    if array.dtype != _NP_OF.get(want.dtype):
        raise TypeError(f"{path}: expected {want.dtype}, got {array.dtype}")
    if tuple(array.shape) != tuple(want.shape):
        raise ValueError(f"{path}: expected shape {tuple(want.shape)}, got "
                         f"{tuple(array.shape)}")
    return torch.from_numpy(array.copy()).to(device)


def adamw_state_from_numpy(cfg, tree: Mapping[str, Any], acfg=None,
                           device: DeviceLike = None):
    """The reference's ``adamw_init``/``adamw_update`` state for
    ``LM(cfg)``'s parameters (``{"m", "v", "count"}``, moments float32 or,
    with ``acfg.quantized``, ``{"q": int8, "scale": float32}``), as nested
    dicts of numpy arrays, as the port's state on ``device``. Names, shapes
    and dtypes must match the port's ``adamw_init`` exactly."""
    from repro_torch.models import LM
    from repro_torch.optim.adamw import AdamWConfig, adamw_init
    dev = resolve_device(device)
    spec = adamw_init(LM(cfg, device="meta").init(), acfg or AdamWConfig())

    def walk(node, want, path):
        if isinstance(want, dict):
            if not isinstance(node, Mapping) or set(node) != set(want):
                got = sorted(node) if isinstance(node, Mapping) else type(node)
                raise KeyError(f"{path or 'state'}: expected keys "
                               f"{sorted(want)}, got {got}")
            return {k: walk(node[k], want[k], f"{path}/{k}") for k in want}
        if isinstance(node, Mapping):
            raise KeyError(f"{path}: expected an array, got keys "
                           f"{sorted(node)} (a quantized moment?)")
        return _state_tensor(node, path, want, dev)

    return walk(tree, spec, "")


def _to_numpy(tree):
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    t = tree.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy().copy()


def lm_params_to_numpy(params):
    """The port's parameters as nested dicts of numpy arrays, the layout
    ``lm_params_from_numpy`` takes (bfloat16 leaves widened to float32,
    exactly: numpy has no bfloat16)."""
    return _to_numpy(params)


def adamw_state_to_numpy(state):
    """The port's AdamW state as nested dicts of numpy arrays, the layout
    ``adamw_state_from_numpy`` takes."""
    return _to_numpy(state)
