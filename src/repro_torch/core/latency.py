"""Latency models (paper §3.2, Fig. 1).

The paper fits decode latency as linear in batch size B (``L ≈ αB + β``) and
in retained KV budget C (``L ≈ γC + δ``).  Both are cross-sections of one
bilinear surface — attention-decode work is Σ over (row, head) of retained
length, plus fixed overheads — so we fit

    t(B, C) = a + b·B + c·C + d·B·C

by least squares (``LinearLatencyModel.fit``).  ``RooflineLatencyModel`` is
the analytic v5e counterpart used when no measurements exist: decode is
HBM-bound, t = bytes/bw with bytes = weights_per_shard + Σ len·head_dim·2·dtype.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence, Tuple

import numpy as np

# TPU v5e constants (per the assignment spec)
PEAK_FLOPS_BF16 = 197e12  # FLOP/s per chip
HBM_BW = 819e9  # bytes/s per chip
ICI_BW = 50e9  # bytes/s per link


@dataclass
class LinearLatencyModel:
    """t(B, C) = a + b·B + c·C + d·B·C   (microseconds)."""

    a: float
    b: float
    c: float
    d: float

    def latency(self, batch: float, budget: float) -> float:
        return self.a + self.b * batch + self.c * budget + self.d * batch * budget

    def shard_latency(self, per_row_lengths: np.ndarray) -> float:
        """Latency of one shard given the retained lengths it owns.

        ``per_row_lengths``: array of (owned row, slot) retained lengths.  The
        B·C term becomes Σ lengths; the B term counts owned rows once.
        """
        total_len = float(per_row_lengths.sum())
        n_rows = float((per_row_lengths > 0).sum())
        return self.a + self.b * n_rows + self.d * total_len + self.c * (
            per_row_lengths.max(initial=0.0))

    @staticmethod
    def fit(samples: Sequence[Tuple[float, float, float]]) -> "LinearLatencyModel":
        """samples: (batch, budget, measured_latency)."""
        A = np.array([[1.0, B, C, B * C] for B, C, _ in samples])
        y = np.array([t for _, _, t in samples])
        coef, *_ = np.linalg.lstsq(A, y, rcond=None)
        return LinearLatencyModel(*map(float, coef))

    def r2(self, samples: Sequence[Tuple[float, float, float]]) -> float:
        y = np.array([t for _, _, t in samples])
        pred = np.array([self.latency(B, C) for B, C, _ in samples])
        ss_res = float(((y - pred) ** 2).sum())
        ss_tot = float(((y - y.mean()) ** 2).sum())
        return 1.0 - ss_res / ss_tot if ss_tot > 0 else 1.0


@dataclass
class RooflineLatencyModel:
    """Analytic v5e decode-attention latency: HBM-bound KV reads + fixed part.

    fixed_bytes: per-shard per-step bytes independent of KV load (weight reads,
    activations).  kv_bytes_per_token: head_dim · 2(K,V) · dtype_bytes.
    """

    fixed_bytes: float
    kv_bytes_per_token: float
    hbm_bw: float = HBM_BW

    def shard_latency(self, total_retained_tokens: float) -> float:
        return (self.fixed_bytes + self.kv_bytes_per_token * total_retained_tokens) / self.hbm_bw


def decode_attention_flops(batch: int, lengths_sum: float, head_dim: int,
                           q_per_kv: int) -> float:
    """FLOPs of decode attention given Σ retained lengths (per shard)."""
    # qk^T and p·v, per query head in the group
    return 4.0 * q_per_kv * head_dim * lengths_sum


def decode_attention_bytes(lengths_sum: float, head_dim: int,
                           dtype_bytes: int = 2) -> float:
    """HBM bytes for KV reads at decode (per shard)."""
    return 2.0 * head_dim * dtype_bytes * lengths_sum
