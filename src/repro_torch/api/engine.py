"""The `Engine` facade: one front door for FairKV serving.

Owns the serving composition — parameter init, plan construction,
slot-layout weight permutation, cache backend and cache state — behind a
few methods:

- one-shot: `Engine.generate(prompts, max_new_tokens)` runs prefill +
  compression + the decode loop on the configured cache backend and
  returns a `GenerationResult` (tokens, logits, realized per-head lengths,
  plan metrics, timings);
- continuous: `submit` / `step` / `stream` / `run_trace` / `cancel` /
  `drain` drive the request scheduler
  (`repro_torch.serving.scheduler.Scheduler`, with chunked prefill and
  shared-prefix reuse per ``EngineConfig.prefix``, self-speculative when
  ``EngineConfig.speculation`` is enabled); `stream` yields a
  `StreamEvent` per generated token; `prefix_stats()` reports the prefix
  index's counters;
- `replan()` rebuilds the head placement (online, from the live cache, in
  continuous mode) by copying into the live tensors; `memory_stats()`
  reports the cache footprint; `warmup()` captures the continuous steps
  before any timed region;
- `Engine.measure_profile(batch)` runs a profiling prefill and returns the
  (L, H) realized per-head retained lengths (the paper's §4.1 offline
  statistic) for feeding into a fresh `build` — as its planning profile,
  or as ``head_importance``, the ``headkv`` policy's per-head weights;
- observability: `stats()` (one typed `EngineStats` snapshot), `metrics()`
  / `metrics_prometheus()` / `metrics_jsonl()` and `trace_export()` read
  the engine's `Obs` handle (``EngineConfig.obs``), threaded through the
  executor, the backends and the scheduler.

The facade holds the *original-layout* parameters (`.params`, shareable
between engines) and exposes the plan (`.plan`), plan arrays (`.pa`),
slot-layout weights (`.sp`) and the live scheduler (`.scheduler`).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.api.config import DTYPES, EngineConfig
from repro_torch.api.stats import EngineStats, collect_stats
from repro_torch.cache.slot_cache import PlanArrays, SlotCache, copy_fields_, migrate_cache
from repro_torch.core.placement import HeadPlacement
from repro_torch.core.planner import build_plan
from repro_torch.core.profiles import profile_from_lengths, synthetic_profile
from repro_torch.exec.base import make_executor
from repro_torch.models import init_params
from repro_torch.obs import Obs
from repro_torch.paging.block_pool import PoolExhausted
from repro_torch.serving import engine as _serve
from repro_torch.serving.cache_backend import make_cache_backend
from repro_torch.serving.request import Request
from repro_torch.serving.scheduler import Scheduler


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


@dataclass(frozen=True)
class StreamEvent:
    """One generated token from the continuous-mode `Engine.stream`."""

    req_id: int
    token: int
    index: int  # position within the request's generated sequence
    step: int  # scheduler step that produced it
    finished: bool  # True on the request's last token


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
                 profile: np.ndarray, head_importance: Optional[np.ndarray] = None):
        self.cfg = cfg
        self.device = resolve_device(cfg.device)
        self.params = params  # original layout, shared with other engines
        self.plan = plan
        self.profile = profile  # (L, H) planning profile
        self.head_importance = head_importance  # headkv per-head weights
        # the same weights on the device: one (L, Hkv) tensor the prefill
        # and chunk steps read (a captured chunk step copies it in per call)
        self._head_importance = (None if head_importance is None else torch.as_tensor(
            np.asarray(head_importance), dtype=torch.float32, device=self.device))
        self.pa = PlanArrays.from_plan(plan, device=self.device)
        with torch.inference_mode():
            self.sp = _serve.slotify_params(params, plan, cfg.model)
        # one registry + trace per engine, threaded through the executor,
        # the backends and (lazily) the scheduler
        self.obs = Obs.build(cfg.obs)
        # runs the steps: CUDA graphs on the card, eager on the CPU.  A
        # caller may put another executor here before the first step (an
        # eager one, LocalExecutor(..., graphs=False), to compare against)
        self.executor = make_executor(cfg.executor, cfg.model, cfg.compression,
                                      exec_cfg=cfg.executor_cfg, paging=cfg.paging,
                                      device=self.device, obs=self.obs)
        self.backend = self._make_backend()
        self.state: Optional[_serve.ServeState] = None
        # the one-shot decode state; every generate() of the same shapes
        # lands in these tensors, so a captured decode step is reused
        self._live: Optional[_serve.ServeState] = None
        self._mode: Optional[str] = None  # "oneshot" | "continuous" (last used)
        self._scheduler: Optional[Scheduler] = None
        self._next_req_id = 0
        self._drain_pending = False  # drain() before the scheduler exists

    def _make_backend(self):
        c = self.cfg
        return make_cache_backend(
            c.cache_backend, c.model, c.compression,
            max_live_tokens=c.scheduler.max_live_tokens, paging=c.paging,
            n_shards=c.n_shards,
            max_live_tokens_per_shard=c.scheduler.max_live_tokens_per_shard,
            obs=self.obs)

    @classmethod
    def build(cls, cfg: EngineConfig, *, params: Optional[dict] = None,
              profile: Optional[np.ndarray] = None,
              head_importance: Optional[np.ndarray] = None) -> "Engine":
        """Assemble an engine: params (initialised on the device from
        ``cfg.seed`` if not given), plan, slot weights.

        ``profile`` is the (L, H) expected per-head workload the planner
        optimizes; default is a synthetic profile seeded from
        ``cfg.profile_seed`` / ``cfg.profile_skew`` (swap in a measured one
        from `measure_profile` for paper-faithful planning).
        ``head_importance`` ((L, Hkv)) gives the ``headkv`` policy its
        per-head weights (a measured profile, for instance); without it
        ``headkv`` weighs heads by their realized mean score.  Raises if
        the config asks for CUDA and there is none.
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
        return cls(cfg, params, plan, profile, head_importance=head_importance)

    # ---- one-shot serving --------------------------------------------------

    def prefill(self, batch: Union[Dict[str, torch.Tensor], np.ndarray]):
        """Run the prompt through prefill+compression; holds the resulting
        cache on ``self.state``.  Returns (logits (B, V), lengths
        (L, Hkv, B))."""
        state, logits, lengths = self.executor.prefill(
            self.sp, self._as_batch(batch), self.pa,
            head_importance=self._head_importance)
        self.state = state
        self._mode = "oneshot"
        return logits, lengths

    @torch.inference_mode()
    def generate(self, prompts: Union[Dict[str, torch.Tensor], np.ndarray],
                 max_new_tokens: int,
                 teacher_tokens: Optional[np.ndarray] = None,
                 collect_logits: bool = True) -> GenerationResult:
        """One-shot batch generation: prefill + ``max_new_tokens`` decode
        steps.

        ``prompts`` is a (B, T) int token array or a batch dict.
        ``teacher_tokens`` (B, max_new_tokens), when given, forces the token
        *fed* at each decode step; the returned ``tokens`` are still the
        model's argmax choices.  The prefilled cache is re-housed in the
        configured backend's layout (the paged backend allocates blocks for
        the realized lengths) and each step's appends get their storage
        first (`prepare_decode`); one-shot mode cannot preempt, so a pool
        that runs dry is a configuration error.  A later call with the same
        shapes copies its prefilled state into the first call's tensors, so
        the decode step captured then serves it.
        """
        t0 = time.perf_counter()
        logits, lengths = self.prefill(prompts)
        prefill_s = time.perf_counter() - t0
        # one-shot TTFT is the prefill wall (no queue to wait in)
        self.obs.metrics.histogram(
            "ttft_s", help="time to first token (queue wait + prefill "
                           "wall time)").observe(prefill_s)
        try:
            self.state = self.backend.from_prefill(self.state, self.pa)
        except PoolExhausted as e:
            raise ValueError(
                f"cache pool too small for one-shot generation ({e}); raise "
                f"PagingConfig.n_blocks or leave it 0 for worst-case sizing") from e
        if (self._live is not None
                and _serve.state_layout(self._live) == _serve.state_layout(self.state)):
            self.state = _serve.copy_state_(self._live, self.state)
        self._live = state = self.state
        # last_tokens is updated in place: keep host copies
        tokens = [state.last_tokens.cpu().numpy().copy()]
        logits_all = [logits.cpu().numpy()] if collect_logits else None
        step_s: List[float] = []
        for t in range(max_new_tokens):
            tok = (None if teacher_tokens is None else torch.as_tensor(
                np.asarray(teacher_tokens)[:, t], dtype=torch.int64,
                device=self.device))
            t0 = time.perf_counter()
            try:
                state = self.backend.prepare_decode(state, None)
            except PoolExhausted as e:
                raise ValueError(
                    f"cache pool ran dry at decode step {t} ({e}); one-shot "
                    f"generation cannot preempt — raise PagingConfig.n_blocks") from e
            state, lg = self.executor.decode(self.sp, state, self.pa, tok)
            step_s.append(time.perf_counter() - t0)
            self.obs.metrics.histogram(
                "itl_s", help="inter-token latency (per-request mean in "
                              "continuous mode; per-step in one-shot mode)"
            ).observe(step_s[-1])
            self.state = state
            tokens.append(state.last_tokens.cpu().numpy().copy())
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
        saved, mode = self.state, self._mode
        try:
            _, lengths = self.prefill(batch)
            return profile_from_lengths(lengths.cpu().numpy().astype(np.float64))
        finally:
            self.state, self._mode = saved, mode

    # ---- replanning --------------------------------------------------------

    @torch.inference_mode()
    def replan(self, profile: Optional[np.ndarray] = None,
               shard_speeds: Optional[Sequence[float]] = None) -> dict:
        """Rebuild the head placement and swap it in.

        Continuous mode (scheduler live): the scheduler's online replan —
        live-cache migration, kept only if the realized imbalance drops —
        from the realized profile unless ``profile`` / ``shard_speeds``
        override the inputs.  One-shot mode: the plan is rebuilt from
        ``profile`` (default: the build-time profile) and ``shard_speeds``,
        and a live cache is migrated into the new layout.
        """
        if self._scheduler is not None:
            event = self._scheduler.replan(profile=profile, shard_speeds=shard_speeds)
            self._sync_from_scheduler()
            return event
        prof = self.profile if profile is None else np.asarray(profile)
        speeds = None if shard_speeds is None else np.asarray(shard_speeds, float)
        self.plan = build_plan(prof, self.cfg.n_shards, self.cfg.planner,
                               shard_speeds=speeds)
        self.profile = prof
        new_pa = PlanArrays.from_plan(self.plan, device=self.device)
        migrated = False
        # copies into the live tensors (cache, plan arrays, slot weights):
        # captured steps keep their inputs
        if self.state is not None:
            if isinstance(self.state.cache, SlotCache):
                # prefill leaves the slot layout whatever the backend
                copy_fields_(self.state.cache,
                             migrate_cache(self.state.cache, self.pa, new_pa))
            else:
                _, commit = self.backend.migrate_cache(self.state.cache, self.pa,
                                                       new_pa)
                commit()
            migrated = True
        copy_fields_(self.pa, new_pa)
        self.backend.pa = self.pa
        _serve.slotify_params(self.params, self.plan, self.cfg.model, out=self.sp)
        return {"plan": self.plan, "migrated_cache": migrated,
                "shard_speeds": None if speeds is None else list(speeds)}

    # ---- continuous serving ------------------------------------------------

    @property
    def scheduler(self) -> Optional[Scheduler]:
        """The live continuous-batching scheduler (None until first used)."""
        return self._scheduler

    def _ensure_scheduler(self) -> Scheduler:
        self._mode = "continuous"
        if self._scheduler is None:
            # its OWN backend instance: a backend carries allocator state
            # (pool + table mirror), and a later one-shot generate() resets
            # the engine's backend
            self._scheduler = Scheduler(
                self.cfg.model, self.params, self.plan, self.cfg.compression,
                self.cfg.scheduler, self.executor, planner_cfg=self.cfg.planner,
                dtype=DTYPES[self.cfg.dtype], serve_params=self.sp,
                backend=self._make_backend(), spec_cfg=self.cfg.speculation,
                prefix_cfg=self.cfg.prefix, head_importance=self.head_importance,
                obs=self.obs, plan_profile=self.profile)
            if self._drain_pending:
                self._scheduler.drain()
        return self._scheduler

    def _sync_from_scheduler(self) -> None:
        """Adopt the scheduler's plan after an online replan.  The slot
        weights are one object shared with the scheduler; the plan arrays
        are copied into the engine's own, on which a captured one-shot
        decode step reads them."""
        sched = self._scheduler
        if sched is not None and sched.plan is not self.plan:
            self.plan = sched.plan
            copy_fields_(self.pa, sched.pa)

    def warmup(self) -> None:
        """Capture the continuous steps outside any timed region, with the
        reference's semantics: one all-inactive tick (no appends, lengths
        and positions untouched; only the retired rows' last tokens change),
        after which ``decode_steps`` (the ring phase) is restored, so a
        warmed scheduler stays step for step the same as a cold one.  With
        speculation on, the tick is an all-inactive propose + verify pair
        after the decode step; with chunking on, one chunk step also runs
        on a scratch B = 1 sub-state.  A no-op when requests are live or
        mid-prefill (their steps are captured by then).  On the card it
        returns with the decode graph captured, and the propose / verify
        or chunk graphs when those are on."""
        sched = self._ensure_scheduler()
        if sched.active or sched.prefilling:
            return
        with torch.inference_mode():
            ex, state = self.executor, sched.state
            steps0 = state.decode_steps
            rows = self.cfg.scheduler.max_rows
            idle = torch.zeros((rows,), dtype=torch.bool, device=self.device)
            state, _ = ex.decode(sched.sp, state, sched.pa, active=idle)
            if sched.spec is not None:
                spec = sched.spec
                d = spec.draft_layers if spec.draft_layers > 0 else self.cfg.model.n_layers
                zero = torch.zeros((rows,), dtype=torch.int32, device=self.device)
                state, props = ex.propose(sched.sp, state, sched.pa, zero, active=idle,
                                          draft_layers=d, max_k=spec.max_k)
                window = torch.cat([state.last_tokens[:, None], props], dim=1)
                state, *_ = ex.verify(sched.sp, state, sched.pa, window, zero + 1,
                                      active=idle, draft_layers=d)
            state.decode_steps = steps0
            sched.state = state
            if sched._chunk_ok:
                Ck = sched.prefix_cfg.chunk_tokens
                scratch = _serve.init_serve_state(
                    self.cfg.model, sched.pa, 1, self.cfg.compression,
                    dtype=DTYPES[self.cfg.dtype], device=self.device)
                ex.prefill_chunk(sched.sp, np.zeros((1, Ck), np.int64), sched.pa, scratch,
                                 rows=[0], start=[0], valid=[Ck],
                                 quota=sched._chunk_quota(Ck, Ck),
                                 head_importance=sched._head_importance)

    def submit(self, request: Union[Request, np.ndarray, Sequence[int]],
               max_new_tokens: int = 16, eos_id: Optional[int] = None,
               arrival_step: int = 0, priority: int = 1) -> Request:
        """Queue a request (continuous mode): a prepared `Request` or a raw
        prompt token sequence."""
        if not isinstance(request, Request):
            request = Request(req_id=self._next_req_id,
                              prompt=np.asarray(request, np.int32),
                              arrival_step=arrival_step,
                              max_new_tokens=max_new_tokens, eos_id=eos_id,
                              priority=priority)
        self._next_req_id = max(self._next_req_id, request.req_id + 1)
        self._ensure_scheduler().submit(request)
        return request

    def cancel(self, request_id: int) -> bool:
        """Retire an in-flight or queued request early; its row and blocks
        are released like a normal retirement.  False when unknown."""
        if self._scheduler is None:
            return False
        return self._scheduler.cancel(request_id)

    def drain(self) -> None:
        """Graceful shutdown: stop admitting, let live rows finish."""
        self._drain_pending = True
        if self._scheduler is not None:
            self._scheduler.drain()

    def step(self) -> dict:
        """One scheduler tick: admit → decode → retire → (maybe) replan."""
        ev = self._ensure_scheduler().step()
        self._sync_from_scheduler()
        return ev

    def stream(self, requests: Sequence[Request],
               max_steps: int = 10_000) -> Iterator[StreamEvent]:
        """Drive a trace, yielding a `StreamEvent` per generated token as
        the ticks complete; requests enter at their ``arrival_step``, and
        the stream ends when all of them have finished or after
        ``max_steps``."""
        sched = self._ensure_scheduler()
        pending = sorted(requests, key=lambda r: (r.arrival_step, r.req_id))
        emitted = {r.req_id: 0 for r in pending}
        i = 0
        while any(not r.is_finished for r in pending) and sched.step_idx < max_steps:
            while i < len(pending) and pending[i].arrival_step <= sched.step_idx:
                self.submit(pending[i])
                i += 1
            ev = sched.step()
            self._sync_from_scheduler()
            for req in pending:
                n = req.n_generated
                while emitted[req.req_id] < n:
                    k = emitted[req.req_id]
                    emitted[req.req_id] = k + 1
                    yield StreamEvent(req_id=req.req_id, token=req.generated[k],
                                      index=k, step=ev["step"],
                                      finished=req.is_finished and k == n - 1)

    def run_trace(self, requests: Sequence[Request],
                  max_steps: int = 10_000) -> dict:
        """Drive a full trace to completion; returns the scheduler's summary
        (steps, tokens/s, replan log, preemptions, latency, memory)."""
        out = self._ensure_scheduler().run(requests, max_steps=max_steps)
        self._sync_from_scheduler()
        return out

    # ---- observability -------------------------------------------------------

    def stats(self) -> EngineStats:
        """One typed snapshot of the engine's operational state: nested
        ``scheduler`` / ``pool`` / ``prefix`` / ``plan`` / ``speculation``
        sections (`repro_torch.api.stats.EngineStats`).  Always
        constructible: a section without a live source has ``None`` fields
        and an empty ``detail``."""
        return collect_stats(self)

    def prefix_stats(self) -> dict:
        """The raw ``detail`` of ``stats().prefix`` (the index's counters
        and census; empty until a continuous scheduler with sharing on
        exists)."""
        return self.stats().prefix.detail

    def metrics(self) -> dict:
        """Deterministic snapshot of every metric family (counters, gauges,
        histograms with cumulative buckets); ``{}`` when obs is off."""
        return self.obs.metrics.snapshot()

    def metrics_prometheus(self) -> str:
        """Prometheus text exposition of the metrics registry."""
        return self.obs.metrics.to_prometheus()

    def metrics_jsonl(self) -> str:
        """One JSON object per metric series (appendable log format)."""
        return self.obs.metrics.to_jsonl()

    def trace_export(self) -> str:
        """Chrome trace-event JSON of the recent span window (Perfetto,
        chrome://tracing)."""
        return self.obs.trace.export_json()

    @property
    def finished_requests(self) -> List[Request]:
        return [] if self._scheduler is None else self._scheduler.finished

    @property
    def replan_log(self) -> List[dict]:
        """``stats().scheduler.replan_log``."""
        return self.stats().scheduler.replan_log

    def imbalance(self) -> float:
        """max/mean realized per-shard KV load (continuous mode); raises
        until the scheduler exists (``stats().scheduler.imbalance`` is None
        then)."""
        v = self.stats().scheduler.imbalance
        if v is None:
            raise RuntimeError("imbalance() requires the continuous "
                               "scheduler; call submit/stream first")
        return v

    def memory_stats(self) -> dict:
        """The raw ``detail`` of ``stats().pool``: the cache footprint of
        whichever mode (one-shot / continuous) ran most recently; raises
        with no live cache."""
        pool = self.stats().pool
        if not pool.detail:
            raise RuntimeError("memory_stats() needs a live cache; call "
                               "generate/prefill or submit/stream first")
        return pool.detail

    def _as_batch(self, batch) -> Dict[str, torch.Tensor]:
        if isinstance(batch, dict):
            return {k: torch.as_tensor(v, device=self.device) for k, v in batch.items()}
        return {"tokens": torch.as_tensor(np.asarray(batch), dtype=torch.int64,
                                          device=self.device)}
