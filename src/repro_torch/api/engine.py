"""The `Engine` facade: one front door for FairKV one-shot serving.

Owns the serving composition — parameter init, plan construction,
slot-layout weight permutation, and cache state — behind a few methods:

- `Engine.generate(prompts, max_new_tokens)` runs prefill + compression +
  the decode loop and returns a `GenerationResult` (tokens, logits,
  realized per-head lengths, plan metrics, timings);
- `Engine.measure_profile(batch)` runs a profiling prefill and returns the
  (L, H) realized per-head retained lengths (the paper's §4.1 offline
  statistic) for feeding into a fresh `build`.

The facade holds the *original-layout* parameters (`.params`, shareable
between engines) and exposes the plan (`.plan`), plan arrays (`.pa`) and
slot-layout weights (`.sp`).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Union

import numpy as np
import torch

from repro_torch.api.config import DTYPES, EngineConfig
from repro_torch.cache.slot_cache import PlanArrays
from repro_torch.core.placement import HeadPlacement
from repro_torch.core.planner import build_plan
from repro_torch.core.profiles import profile_from_lengths, synthetic_profile
from repro_torch.exec.local import LocalExecutor
from repro_torch.models import init_params
from repro_torch.serving import engine as _serve


@dataclass
class GenerationResult:
    """Output of `Engine.generate`.

    ``tokens[:, 0]`` is the prefill argmax (the first generated token);
    ``tokens[:, 1:]`` come from the decode loop.  ``logits`` aligns with
    ``tokens``: entry t is the distribution the t-th token was taken from.
    ``lengths`` is the realized per-head retained-length tensor
    (L, Hkv, B) — the paper's workload observable; ``realized_profile``,
    ``efficiency`` and ``makespan`` are derived from it against the plan.
    ``prefill_s`` and ``step_s`` are host wall times of device-synchronized
    steps.
    """

    tokens: np.ndarray  # (B, 1 + steps)
    logits: Optional[np.ndarray]  # (B, 1 + steps, V) fp32 when collected
    lengths: np.ndarray  # (L, Hkv, B)
    realized_profile: np.ndarray  # (L, Hkv)
    efficiency: float  # plan E (Eq. 5) on the realized profile
    makespan: float  # plan max-shard load on the realized profile
    prefill_s: float
    step_s: List[float] = field(default_factory=list)


def resolve_device(device: str) -> torch.device:
    """The configured device; CUDA must exist unless the CPU was asked for."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"EngineConfig.device={device!r} but CUDA is not available; "
            f"pass device='cpu' to run the plain PyTorch path")
    return dev


class Engine:
    """Facade over the FairKV serving stack.  Construct via `Engine.build`."""

    def __init__(self, cfg: EngineConfig, params: dict, plan: HeadPlacement,
                 profile: np.ndarray):
        self.cfg = cfg
        self.device = resolve_device(cfg.device)
        self.params = params  # original layout, shared with other engines
        self.plan = plan
        self.profile = profile  # (L, H) planning profile
        self.pa = PlanArrays.from_plan(plan, device=self.device)
        with torch.inference_mode():
            self.sp = _serve.slotify_params(params, plan, cfg.model)
        self.executor = LocalExecutor(cfg.model, cfg.compression, self.device)
        self.state: Optional[_serve.ServeState] = None

    @classmethod
    def build(cls, cfg: EngineConfig, *, params: Optional[dict] = None,
              profile: Optional[np.ndarray] = None) -> "Engine":
        """Assemble an engine: params (initialised on the device from
        ``cfg.seed`` if not given), plan, slot weights.

        ``profile`` is the (L, H) expected per-head workload the planner
        optimizes; default is a synthetic profile seeded from
        ``cfg.profile_seed`` / ``cfg.profile_skew`` (swap in a measured one
        from `measure_profile` for paper-faithful planning).  Raises if the
        config asks for CUDA and there is none.
        """
        device = resolve_device(cfg.device)
        model = cfg.model
        if params is None:
            params = init_params(model, cfg.seed, dtype=DTYPES[cfg.dtype],
                                 device=device)
        if profile is None:
            profile = synthetic_profile(
                model.n_layers, model.n_kv_heads,
                budget=cfg.compression.budget, skew=cfg.profile_skew,
                seed=cfg.profile_seed)
        plan = build_plan(profile, cfg.n_shards, cfg.planner)
        return cls(cfg, params, plan, profile)

    # ---- one-shot serving --------------------------------------------------

    def prefill(self, batch: Union[Dict[str, torch.Tensor], np.ndarray]):
        """Run the prompt through prefill+compression; holds the resulting
        cache on ``self.state``.  Returns (logits (B, V), lengths
        (L, Hkv, B))."""
        state, logits, lengths = self.executor.prefill(
            self.sp, self._as_batch(batch), self.pa)
        self.state = state
        return logits, lengths

    def generate(self, prompts: Union[Dict[str, torch.Tensor], np.ndarray],
                 max_new_tokens: int,
                 teacher_tokens: Optional[np.ndarray] = None,
                 collect_logits: bool = True) -> GenerationResult:
        """One-shot batch generation: prefill + ``max_new_tokens`` decode
        steps.

        ``prompts`` is a (B, T) int token array or a batch dict.
        ``teacher_tokens`` (B, max_new_tokens), when given, forces the token
        *fed* at each decode step; the returned ``tokens`` are still the
        model's argmax choices.
        """
        t0 = time.perf_counter()
        logits, lengths = self.prefill(prompts)
        prefill_s = time.perf_counter() - t0
        state = self.state
        tokens = [state.last_tokens.cpu().numpy()]
        logits_all = [logits.cpu().numpy()] if collect_logits else None
        step_s: List[float] = []
        for t in range(max_new_tokens):
            tok = (None if teacher_tokens is None else torch.as_tensor(
                np.asarray(teacher_tokens)[:, t], dtype=torch.int64,
                device=self.device))
            t0 = time.perf_counter()
            state, lg = self.executor.decode(self.sp, state, self.pa, tok)
            step_s.append(time.perf_counter() - t0)
            self.state = state
            tokens.append(state.last_tokens.cpu().numpy())
            if collect_logits:
                logits_all.append(lg.cpu().numpy())
        lengths_np = lengths.cpu().numpy()
        realized = profile_from_lengths(lengths_np.astype(np.float64))
        return GenerationResult(
            tokens=np.stack(tokens, axis=1),
            logits=(np.stack(logits_all, axis=1) if collect_logits else None),
            lengths=lengths_np, realized_profile=realized,
            efficiency=float(self.plan.efficiency(realized)),
            makespan=float(self.plan.makespan(realized)),
            prefill_s=prefill_s, step_s=step_s)

    def measure_profile(self, batch: Union[Dict, np.ndarray]) -> np.ndarray:
        """Profiling pass (paper §4.1): prefill+compression on a sample
        batch; returns the (L, H) mean realized per-head lengths.  The
        selection is plan-independent, so the measurement is valid for
        planning any layout.  Engine state is left untouched."""
        saved = self.state
        try:
            _, lengths = self.prefill(batch)
            return profile_from_lengths(lengths.cpu().numpy().astype(np.float64))
        finally:
            self.state = saved

    def _as_batch(self, batch) -> Dict[str, torch.Tensor]:
        if isinstance(batch, dict):
            return {k: torch.as_tensor(v, device=self.device) for k, v in batch.items()}
        return {"tokens": torch.as_tensor(np.asarray(batch), dtype=torch.int64,
                                          device=self.device)}
