"""Head-workload profiles (paper §3.1, Table 1).

A profile is the (L, H) matrix of expected retained-KV lengths per head under
an imbalanced compression policy.  The paper measures it once per model on a
sample dataset and shows (Table 1) it transfers across datasets
(cosine ≥ 0.94), so the planner can be static.

Here profiles come from two sources:
- ``measure_profile``: run a compression policy over sample batches and average
  the realized per-head lengths — the faithful workflow.
- ``synthetic_profile``: head-skew generators (lognormal / zipf / dirichlet)
  matched to the qualitative shape reported for Ada-SnapKV — used by unit
  tests and by benchmarks that sweep skew levels.
"""
from __future__ import annotations


import numpy as np


def synthetic_profile(
    n_layers: int,
    n_heads: int,
    budget: int,
    skew: float = 1.0,
    kind: str = "lognormal",
    seed: int = 0,
    layer_decay: float = 0.0,
) -> np.ndarray:
    """(L, H) expected retained lengths; per-layer mean == budget.

    ``skew``: 0 → perfectly balanced; larger → heavier per-head imbalance
    (σ of the lognormal / zipf exponent).  ``layer_decay``: PyramidKV-style
    per-layer budget decay (0 = flat).
    """
    rng = np.random.default_rng(seed)
    if kind == "lognormal":
        raw = rng.lognormal(mean=0.0, sigma=skew, size=(n_layers, n_heads))
    elif kind == "zipf":
        ranks = np.argsort(np.argsort(-rng.random((n_layers, n_heads)), axis=1), axis=1) + 1
        raw = 1.0 / ranks ** skew
    elif kind == "dirichlet":
        raw = rng.dirichlet(np.full(n_heads, max(1e-3, 1.0 / max(skew, 1e-6))),
                            size=n_layers)
    else:
        raise ValueError(f"unknown kind {kind!r}")
    # normalize so each layer's head-mean equals the budget (Ada-SnapKV keeps
    # the layer-total pool fixed at H·budget and redistributes it)
    raw = raw / raw.mean(axis=1, keepdims=True)
    prof = raw * budget
    if layer_decay > 0:
        scale = np.linspace(1.0 + layer_decay, 1.0 - layer_decay, n_layers)
        scale = np.clip(scale, 0.05, None)
        prof = prof * scale[:, None]
        prof = prof / prof.mean() * budget
    return np.maximum(prof, 1.0)


def profile_from_lengths(lengths: np.ndarray) -> np.ndarray:
    """(L, H, B) realized lengths → (L, H) profile (mean over batch rows)."""
    arr = np.asarray(lengths, dtype=np.float64)
    if arr.ndim != 3:
        raise ValueError("expected (L, H, B) lengths")
    return arr.mean(axis=-1)


def profile_from_samples(samples: np.ndarray) -> np.ndarray:
    """(n_samples, L, H) per-sample profiles → (L, H) averaged profile."""
    arr = np.asarray(samples, dtype=np.float64)
    if arr.ndim != 3:
        raise ValueError("expected (n_samples, L, H)")
    return arr.mean(axis=0)


def cosine_similarity(a: np.ndarray, b: np.ndarray) -> float:
    """Table 1 metric: cosine of two flattened (L, H) profiles."""
    a = np.asarray(a, float).ravel()
    b = np.asarray(b, float).ravel()
    denom = np.linalg.norm(a) * np.linalg.norm(b)
    return float(a @ b / denom) if denom > 0 else 1.0
