"""Serving: prefill/decode step factories and a batched generation engine
(``repro/serve/engine.py`` without its ``repro.obs`` telemetry, which is
ROADMAP.md queue 1 work).

Sampling runs outside the decode step, and the per-step host copy of the
sampled tokens lies outside both, as in the reference.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.device import DeviceLike
from repro_torch.models import LM


def make_prefill_step(cfg, max_seq: Optional[int] = None,
                      device: DeviceLike = None):
    lm = LM(cfg, device)

    def prefill(params, batch):
        return lm.prefill(params, batch, max_seq=max_seq)

    return lm, prefill


def make_decode_step(cfg, device: DeviceLike = None):
    lm = LM(cfg, device)

    def decode(params, cache, batch):
        return lm.decode(params, cache, batch)

    return lm, decode


def sample_greedy(logits: torch.Tensor) -> torch.Tensor:
    return torch.argmax(logits, dim=-1).to(torch.int32)


def sample_temperature(generator: torch.Generator, logits: torch.Tensor,
                       temperature: float = 0.8) -> torch.Tensor:
    probs = torch.softmax(logits.float() / temperature, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0].to(
        torch.int32)


class Engine:
    """Batched greedy/temperature generation."""

    def __init__(self, cfg, params, max_seq: int = 256,
                 device: DeviceLike = None):
        self.cfg = cfg
        self.params = params
        self.max_seq = max_seq
        self.lm, self._prefill = make_prefill_step(cfg, max_seq=max_seq,
                                                   device=device)
        _, self._decode = make_decode_step(cfg, device=self.lm.device)

    @torch.inference_mode()
    def generate(self, batch: Dict[str, Any], steps: int,
                 temperature: Optional[float] = None, seed: int = 0):
        """batch {'tokens': (B, S) int} -> (B, steps) int32 numpy tokens."""
        cache, logits = self._prefill(self.params, batch)
        gen = torch.Generator(device=self.lm.device).manual_seed(seed)
        outs = []
        for _ in range(steps):
            if temperature is None:
                tok = sample_greedy(logits)
            else:
                tok = sample_temperature(gen, logits, temperature)
            outs.append(tok.cpu().numpy())   # host sync, outside both steps
            logits, cache = self._decode(self.params, cache, {"tokens": tok})
        return np.stack(outs, axis=1)
