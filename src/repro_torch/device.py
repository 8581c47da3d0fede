"""Device policy of the port: entry points run on the card unless asked not to.

Every public entry point (``characterize_batch``, ``DesignTable.build`` /
``from_configs``, ``explore``) takes ``device=None`` and passes it through
``resolve_device``:

* ``None`` means ``"cuda"``; with no CUDA device present this raises.
* The CPU is used only when the caller passes ``device="cpu"`` (the tests do).
  There is no silent fallback to the CPU anywhere.
"""
from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[None, str, torch.device]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> the CUDA device; raise if the requested CUDA device is
    absent. Any explicit device (``"cpu"``, ``"cuda:0"``) passes through."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain PyTorch versions "
            "on the CPU")
    return dev
