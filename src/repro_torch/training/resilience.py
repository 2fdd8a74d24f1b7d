"""Fault tolerance and straggler detection (the port of
``repro.training.resilience``).

- ``TrainingSupervisor`` wraps the step loop: periodic async checkpoints,
  restore-on-start, a synchronous final snapshot for preemption, and
  deterministic data replay (the batches are a pure function of the step).
- ``StragglerDetector`` keeps a per-shard step-time EMA; a shard whose EMA
  exceeds ``threshold`` x the median is flagged, and the callback receives
  per-shard speed factors (``core.planner``'s ``shard_speeds`` takes them:
  a slow shard receives proportionally fewer retained-KV tokens).
"""
from __future__ import annotations

import os
import tempfile
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np

from repro_torch.training.checkpoint import (
    AsyncCheckpointer,
    latest_step,
    restore_checkpoint,
    save_checkpoint,
)


@dataclass
class StragglerDetector:
    n_shards: int
    ema_alpha: float = 0.2
    threshold: float = 1.3  # flag shards slower than 1.3x the median
    min_samples: int = 5
    _ema: Optional[np.ndarray] = None
    _count: int = 0

    def observe(self, per_shard_times: np.ndarray) -> Optional[np.ndarray]:
        """Feed one step's per-shard wall times; returns speed factors when a
        straggler is detected (else None)."""
        t = np.asarray(per_shard_times, dtype=np.float64)
        if self._ema is None:
            self._ema = t.copy()
        else:
            self._ema = (1 - self.ema_alpha) * self._ema + self.ema_alpha * t
        self._count += 1
        if self._count < self.min_samples:
            return None
        med = np.median(self._ema)
        if med <= 0:
            return None
        ratio = self._ema / med
        if (ratio > self.threshold).any():
            # speed factor = med/ema (slow shard < 1) — feeds the planner
            return np.clip(med / self._ema, 0.1, 1.0)
        return None


@dataclass
class SupervisorConfig:
    # under the process's temporary directory (``TMPDIR``), apart from the
    # reference's default
    checkpoint_dir: str = field(
        default_factory=lambda: os.path.join(tempfile.gettempdir(), "repro_torch_ckpt"))
    checkpoint_every: int = 100
    keep: int = 3


class TrainingSupervisor:
    """Step-loop harness with restore / checkpoint / straggler hooks."""

    def __init__(self, cfg: SupervisorConfig, n_shards: int = 1,
                 on_straggler: Optional[Callable[[np.ndarray], None]] = None):
        self.cfg = cfg
        self.ckpt = AsyncCheckpointer(cfg.checkpoint_dir, cfg.keep)
        self.detector = StragglerDetector(n_shards)
        self.on_straggler = on_straggler

    def restore_or_init(self, init_state):
        """Resume from the newest committed checkpoint if one exists."""
        step = latest_step(self.cfg.checkpoint_dir)
        if step is None:
            return 0, init_state
        return step, restore_checkpoint(self.cfg.checkpoint_dir, step, init_state)

    def run(self, state, step_fn, get_batch, n_steps: int, start_step: int = 0,
            per_shard_times_fn=None):
        """Run steps [start_step, n_steps); returns (n_steps, state, the last
        step's metrics).

        ``step_fn(state, batch) -> (state, metrics)`` must be pure so the
        deterministic ``get_batch(step)`` replay makes restarts bit-exact.
        """
        metrics = None
        for step in range(start_step, n_steps):
            state, metrics = step_fn(state, get_batch(step))
            if per_shard_times_fn is not None:
                speeds = self.detector.observe(per_shard_times_fn())
                if speeds is not None and self.on_straggler is not None:
                    self.on_straggler(speeds)
            if (step + 1) % self.cfg.checkpoint_every == 0:
                self.ckpt.save(step + 1, state)
        self.ckpt.wait()
        return n_steps, state, metrics

    def emergency_save(self, step: int, state) -> None:
        """Preemption hook: synchronous final snapshot."""
        self.ckpt.wait()
        save_checkpoint(self.cfg.checkpoint_dir, step, state, self.cfg.keep)
