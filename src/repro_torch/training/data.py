"""Deterministic synthetic token batches (port of ``repro.training.data``).

``get_batch(step)`` is a pure function of (seed, step, shape).  Tokens
follow a Zipf-ish marginal with short-range repetition, so attention has
non-trivial statistics and compression policies see realistic score skew.
Same recipe as the reference, drawn from a numpy ``Generator``: it does not
reproduce the reference's ``jax.random`` stream, so tests feed both
packages the same numpy tokens.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np

from repro_torch.configs.base import InputShape, ModelConfig


@dataclass(frozen=True)
class DataConfig:
    seed: int = 0
    zipf_alpha: float = 1.2
    repeat_prob: float = 0.2  # probability a token repeats one from a window
    repeat_window: int = 64


def _zipf_probs(vocab: int, alpha: float) -> np.ndarray:
    p = np.arange(1, vocab + 1, dtype=np.float64) ** (-alpha)
    return p / p.sum()


class SyntheticLM:
    """Deterministic synthetic LM batches for a (model × shape) cell."""

    def __init__(self, cfg: ModelConfig, shape: InputShape,
                 data_cfg: Optional[DataConfig] = None):
        self.cfg = cfg
        self.shape = shape
        self.dc = data_cfg or DataConfig()
        self._probs = _zipf_probs(cfg.vocab_size, self.dc.zipf_alpha)

    def get_batch(self, step: int) -> Dict[str, np.ndarray]:
        """``{"tokens": (B, T) int32}`` on the host."""
        rng = np.random.default_rng([self.dc.seed, step])
        B, S = self.shape.global_batch, self.shape.seq_len
        base = rng.choice(self.cfg.vocab_size, size=(B, S), p=self._probs)
        # inject short-range repeats (structure for attention stats)
        rep = rng.random((B, S)) < self.dc.repeat_prob
        off = rng.integers(1, self.dc.repeat_window + 1, size=(B, S))
        src = np.maximum(np.arange(S)[None, :] - off, 0)
        tokens = np.where(rep, np.take_along_axis(base, src, axis=1), base)
        return {"tokens": tokens.astype(np.int32)}
