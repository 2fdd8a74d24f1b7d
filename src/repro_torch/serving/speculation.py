"""`SpeculationConfig`: self-speculative decoding knobs (port of
``repro.serving.speculation``).

The draft model is a layer-truncated *view* of the target: the first
``draft_layers`` transformer layers followed by the target's own final
norm and unembedding (`repro_torch.models.transformer.draft_view`),
reading and writing the same paged cache.  Propose runs up to ``max_k``
draft steps per tick; one multi-query verify pass through the full model
checks the window and commits the accepted prefix plus the target's own
next token, so every tick commits between 1 and ``k + 1`` tokens and the
committed stream is greedy decode's at any acceptance rate.

``max_k`` bounds the speculation depth; with ``adaptive`` on, each live
request carries its own depth that shrinks toward ``min_k`` when its
realized acceptance falls below ``low_acceptance`` and grows back toward
``max_k`` at or above ``high_acceptance``.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class SpeculationConfig:
    """Knobs for speculative decoding on the paged backend.

    ``draft_layers=0`` means "all layers": the draft *is* the target, so
    every proposal is accepted (a correctness baseline, not a speedup).
    Real configs set ``draft_layers`` to a small prefix of the stack.
    """

    enabled: bool = False
    max_k: int = 4  # speculation depth ceiling (tokens proposed per tick)
    draft_layers: int = 0  # early-exit depth of the draft; 0 -> full model
    adaptive: bool = True  # per-request depth control from acceptance
    min_k: int = 1  # adaptive floor
    low_acceptance: float = 0.3  # shrink depth below this acceptance
    high_acceptance: float = 0.8  # grow depth at/above this acceptance

    def __post_init__(self):
        if self.max_k < 1:
            raise ValueError(f"max_k must be >= 1, got {self.max_k}")
        if not (1 <= self.min_k <= self.max_k):
            raise ValueError(
                f"min_k must satisfy 1 <= min_k <= max_k, got "
                f"min_k={self.min_k} max_k={self.max_k}")
        if self.draft_layers < 0:
            raise ValueError(
                f"draft_layers must be >= 0 (0 = all layers), got "
                f"{self.draft_layers}")
        if not (0.0 <= self.low_acceptance <= self.high_acceptance <= 1.0):
            raise ValueError(
                f"need 0 <= low_acceptance <= high_acceptance <= 1, got "
                f"low={self.low_acceptance} high={self.high_acceptance}")
