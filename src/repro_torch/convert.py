"""Carry the reference's parameter stacks across into the port.

The state of this system is its physics catalog, not weights: the device
stack (``DEVICE_STACK``), the bitcell stack (``stack_bitcells()``) and the
retention time grid. These functions take them as numpy arrays, one per
field, and return the port's tensors on a device, so a caller can check
that both packages compute from the same catalog.
"""
from __future__ import annotations

from typing import Mapping, Type, TypeVar

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
