"""Deterministic, resumable synthetic data pipeline: the port's copy of the
reference's ``repro/data/pipeline.py`` (pure numpy, the same stream).

Every batch is a pure function of (seed, step), so a restart from a
checkpoint reproduces the exact token stream (the supervisor relies on
this). A real deployment would swap ``_synth_tokens`` for a tokenized shard
reader; the iterator state and checkpoint contract stay the same.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict

import numpy as np


@dataclass
class DataState:
    seed: int
    step: int

    def to_dict(self):
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d):
        return cls(**d)


class SyntheticLMData:
    """Markov-ish synthetic token stream with learnable structure (so tiny
    models show decreasing loss)."""

    def __init__(self, cfg, batch_size: int, seq_len: int, seed: int = 0):
        self.cfg = cfg
        self.batch_size = batch_size
        self.seq_len = seq_len
        self.state = DataState(seed=seed, step=0)
        rng = np.random.default_rng(seed)
        self._perm = rng.permutation(cfg.vocab_size)  # fixed bigram successor

    def _synth_tokens(self, rng, shape):
        v = self.cfg.vocab_size
        first = rng.integers(0, v, shape[:-1] + (1,))
        toks = [first[..., 0]]
        noise = rng.random(shape[:-1] + (shape[-1] - 1,))
        rand = rng.integers(0, v, shape[:-1] + (shape[-1] - 1,))
        for t in range(shape[-1] - 1):
            nxt = self._perm[toks[-1]]
            toks.append(np.where(noise[..., t] < 0.8, nxt, rand[..., t]))
        return np.stack(toks, axis=-1).astype(np.int32)

    def next_batch(self) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        rng = np.random.default_rng((self.state.seed, self.state.step))
        self.state.step += 1
        B, S = self.batch_size, self.seq_len
        if cfg.audio_codebooks:
            return {
                "codes": rng.integers(0, cfg.vocab_size,
                                      (B, cfg.audio_codebooks, S)
                                      ).astype(np.int32),
                "cond": rng.normal(size=(B, cfg.cond_len,
                                         cfg.cond_dim)).astype(np.float32),
            }
        batch = {}
        s_text = S
        if cfg.vision:
            s_text -= cfg.num_patches
            batch["patches"] = rng.normal(
                size=(B, cfg.num_patches, cfg.vision_dim)).astype(np.float32)
        if cfg.meta_tokens:
            s_text -= cfg.meta_tokens
        batch["tokens"] = self._synth_tokens(rng, (B, s_text))
        return batch
