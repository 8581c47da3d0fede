"""Serving: prefill/decode step factories and a batched generation engine.

Sampling runs outside the decode step, and the per-step host copy of the
sampled tokens lies outside both, as in the reference. Telemetry
(``repro_torch.obs``): dispatch counts always; wall-time histograms [s] and
the ``serve.prefill`` / ``serve.sample`` / ``serve.decode_step`` spans when
tracing is on. They read the host clock and add no device sync, so on the
card they measure the host's dispatch of each step (its kernels run
asynchronously), as the reference's spans do under JAX's async dispatch.
"""
from __future__ import annotations

import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch import obs
from repro_torch.device import DeviceLike
from repro_torch.models import LM

_C_PREFILL = obs.counter("serve.prefill_calls")
_C_DECODE = obs.counter("serve.decode_steps")
_C_BUILDS = obs.counter("kernels.builds")   # probe= of the serve spans
_H_PREFILL_S = obs.histogram("serve.prefill_s")
_H_DECODE_S = obs.histogram("serve.decode_step_s")
_H_SAMPLE_S = obs.histogram("serve.sample_s")


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
    """One draw a row of ``logits`` (..., V): (B, V) or an audio model's
    (B, nq, V)."""
    probs = torch.softmax(logits.float() / temperature, dim=-1)
    flat = probs.reshape(-1, probs.shape[-1])
    return torch.multinomial(flat, 1, generator=generator).reshape(
        probs.shape[:-1]).to(torch.int32)


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
        """batch {'tokens': (B, S) int} (a vision model's with 'patches',
        an audio model's {'codes': (B, nq, S), 'cond'}) -> (B, steps) int32
        numpy tokens, (B, steps, nq) for audio. ``cond`` goes with every
        decode step."""
        t0 = time.perf_counter()
        # B of the first leaf in the reference's order (keys sorted)
        with obs.span("serve.prefill", probe=_C_BUILDS,
                      batch=int(np.shape(batch[min(batch)])[0])):
            cache, logits = self._prefill(self.params, batch)
        _C_PREFILL.inc()
        _H_PREFILL_S.observe(time.perf_counter() - t0)
        gen = torch.Generator(device=self.lm.device).manual_seed(seed)
        outs = []
        cond = batch.get("cond")
        for i in range(steps):
            t0 = time.perf_counter()
            with obs.span("serve.sample", step=i):
                if temperature is None:
                    tok = sample_greedy(logits)
                else:
                    tok = sample_temperature(gen, logits, temperature)
            _H_SAMPLE_S.observe(time.perf_counter() - t0)
            outs.append(tok.cpu().numpy())  # noqa: HS01 (the tokens to the host, outside both spans)
            dec_batch = {"tokens": tok}
            if cond is not None:
                dec_batch["cond"] = cond
            t0 = time.perf_counter()
            with obs.span("serve.decode_step", probe=_C_BUILDS, step=i):
                logits, cache = self._decode(self.params, cache, dec_batch)
            _C_DECODE.inc()
            _H_DECODE_S.observe(time.perf_counter() - t0)
        return np.stack(outs, axis=1)
