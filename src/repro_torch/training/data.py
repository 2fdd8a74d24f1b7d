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

    def text_len(self) -> int:
        """Token positions per row: a VLM's sequence holds its image tokens
        first."""
        s = self.shape.seq_len
        if self.cfg.is_vlm:
            s = max(1, s - self.cfg.num_image_tokens)
        return s

    def get_batch(self, step: int) -> Dict[str, np.ndarray]:
        """``{"tokens": (B, T) int32}`` on the host, plus the stub
        frontends' inputs: a VLM's ``image_embeds`` (B, I, D) and an
        encoder-decoder's ``frames`` (B, T_enc, D), 0.02 · N(0, 1) as the
        reference draws them (fp32 here; the model casts them)."""
        rng = np.random.default_rng([self.dc.seed, step])
        B, S = self.shape.global_batch, self.text_len()
        base = rng.choice(self.cfg.vocab_size, size=(B, S), p=self._probs)
        # inject short-range repeats (structure for attention stats)
        rep = rng.random((B, S)) < self.dc.repeat_prob
        off = rng.integers(1, self.dc.repeat_window + 1, size=(B, S))
        src = np.maximum(np.arange(S)[None, :] - off, 0)
        tokens = np.where(rep, np.take_along_axis(base, src, axis=1), base)
        batch = {"tokens": tokens.astype(np.int32)}
        D = self.cfg.d_model
        if self.cfg.is_vlm:
            batch["image_embeds"] = (0.02 * rng.standard_normal(
                (B, self.cfg.num_image_tokens, D))).astype(np.float32)
        if self.cfg.is_encoder_decoder:
            batch["frames"] = (0.02 * rng.standard_normal(
                (B, self.cfg.encoder_seq_len, D))).astype(np.float32)
        return batch
