"""Continuous-batching scheduler (port of ``repro.serving.scheduler``).

The decode step is batch-shaped: every tick runs all ``max_rows`` rows,
and a retired row (lengths 0 everywhere) costs no attention work and gives
exactly zero output through the o-projection.  Continuous batching is
therefore row bookkeeping:

- a **freelist** hands out retired rows to queued requests;
- **admission** prefills a request alone, with ownership evaluated at its
  target row (``prefill(..., rows=[row])``), and the cache backend splices
  the sub-state into the live batch;
- **retirement** (EOS or max-new-tokens) clears the row and frees it;
- **preemption**: when the paged pool runs dry before a decode tick, the
  least urgent, then youngest, request goes back to the queue and is
  replayed later from its prompt (greedy decode is deterministic).

On top, the scheduler watches the realized per-shard KV load (Σ lengths
per shard, the paper's Eq. 4 observable); when the max/mean imbalance
stays above a threshold for a whole window and a cooldown has passed, it
plans again from the realized per-head profile, migrates the live cache
into the new layout, and keeps the new plan only if the realized imbalance
drops.

With speculation on (paged backend only), each tick drafts up to ``k``
tokens per row with the target's first layers, checks them in one
multi-query verify pass, commits the accepted run (1 to k + 1 tokens) and
hands the rejected provisional blocks back to the pool.

Not ported yet: the prefix index and chunked prefill (ROADMAP Queue A.7),
and the observability hooks (A.9).
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.cache.slot_cache import PlanArrays
from repro_torch.compression.base import CompressionConfig
from repro_torch.configs.base import ModelConfig
from repro_torch.core.placement import HeadPlacement
from repro_torch.core.planner import PlannerConfig, build_plan
from repro_torch.exec.base import Executor
from repro_torch.paging.block_pool import PoolExhausted
from repro_torch.serving.cache_backend import CacheBackend, make_cache_backend
from repro_torch.serving.engine import _spec_supported, slotify_params
from repro_torch.serving.request import Request, RequestState, latency_percentiles
from repro_torch.serving.speculation import SpeculationConfig


class RowFreelist:
    """Free batch rows, handed out lowest index first (deterministic)."""

    def __init__(self, n_rows: int):
        self.n_rows = n_rows
        self._free = list(range(n_rows))

    def __len__(self) -> int:
        return len(self._free)

    def acquire(self) -> Optional[int]:
        return self._free.pop(0) if self._free else None

    def release(self, row: int) -> None:
        if not 0 <= row < self.n_rows:
            raise ValueError(f"row {row} out of range [0, {self.n_rows})")
        if row in self._free:
            raise ValueError(f"row {row} double-freed")
        self._free.append(row)
        self._free.sort()


@dataclass
class ReplanTrigger:
    """Fires when the imbalance stays above ``threshold`` for a full
    sliding ``window`` of observations, at most once per ``cooldown``
    steps: one transient spike (right after an admission) never fires."""

    window: int = 8
    threshold: float = 1.25
    cooldown: int = 16
    _history: deque = field(default_factory=deque, repr=False)
    _last_fire: Optional[int] = None

    def observe(self, imbalance: float) -> None:
        self._history.append(float(imbalance))
        while len(self._history) > self.window:
            self._history.popleft()

    def ready(self, step: int) -> bool:
        """Armed: a full window above threshold and the cooldown elapsed."""
        if len(self._history) < self.window:
            return False
        if any(x <= self.threshold for x in self._history):
            return False
        return self._last_fire is None or step - self._last_fire >= self.cooldown

    def fire(self, step: int) -> None:
        self._last_fire = step
        self._history.clear()


@dataclass(frozen=True)
class SchedulerConfig:
    max_rows: int = 4  # fixed decode batch width (row slots)
    # slot backend admission budget: projected Σ lengths over (L, H) the
    # live cache may hold; None admits on free rows alone (the paged
    # backend's budget is its free-block pool)
    max_live_tokens: Optional[int] = None
    # slot backend per-model-shard budget: the bottleneck shard gates
    # admission, so balanced plans admit more rows than imbalanced ones
    max_live_tokens_per_shard: Optional[int] = None
    replan_window: int = 8
    replan_threshold: float = 1.25
    replan_cooldown: int = 16
    replan_min_rows: int = 2  # don't replan a near-empty batch
    enable_replan: bool = True
    collect_logits: bool = False  # keep per-token logits on each Request


class Scheduler:
    """Admission + interleaved decode + retirement + online replanning.

    The state's tensors are updated in place under
    ``torch.inference_mode()`` (every public method that touches them
    enters it).  ``step_s`` keeps the host wall time of every tick (each
    decode step ends in a device synchronize, so it covers the device
    work), ``prepare_s`` that of each tick's backend `prepare_decode`
    (block allocation and table copy; preemptions included), and with
    speculation on ``propose_s`` / ``verify_s`` those of each tick's draft
    and verify steps.
    """

    def __init__(self, cfg: ModelConfig, params: dict, plan: HeadPlacement,
                 ccfg: CompressionConfig, scfg: SchedulerConfig,
                 executor: Executor, planner_cfg: Optional[PlannerConfig] = None,
                 dtype=torch.float32, serve_params: Optional[dict] = None,
                 backend: Optional[CacheBackend] = None,
                 spec_cfg: Optional[SpeculationConfig] = None):
        self.cfg = cfg
        self.params = params  # original layout, kept to re-slotify on replan
        self.plan = plan
        self.executor = executor
        self.device = executor.device
        self.pa = PlanArrays.from_plan(plan, device=self.device)
        self.ccfg = ccfg
        self.scfg = scfg
        self.pcfg = planner_cfg or PlannerConfig(
            mode=plan.mode, slots_per_shard=plan.slots_per_shard,
            r_max=plan.r_max, batch_cap=scfg.max_rows)
        self.dtype = dtype
        with torch.inference_mode():
            self.sp = (serve_params if serve_params is not None
                       else slotify_params(params, plan, cfg))
        self.backend = backend if backend is not None else make_cache_backend(
            "slot", cfg, ccfg, max_live_tokens=scfg.max_live_tokens,
            n_shards=plan.n_shards,
            max_live_tokens_per_shard=scfg.max_live_tokens_per_shard)
        with torch.inference_mode():
            self.state = self.backend.init_state(self.pa, scfg.max_rows, dtype)
        # speculative decoding: provisional blocks come from the same pool
        # as ordinary decode growth, and rejection trims them back
        self.spec = spec_cfg if spec_cfg is not None and spec_cfg.enabled else None
        if self.spec is not None:
            _spec_supported(cfg)
            if self.backend.name != "paged":
                raise ValueError(
                    "speculative decoding needs the paged backend "
                    "(provisional blocks + rollback), got "
                    f"cache_backend={self.backend.name!r}")
            if self.spec.draft_layers > cfg.n_layers:
                raise ValueError(
                    f"speculation.draft_layers={self.spec.draft_layers} exceeds "
                    f"the model's {cfg.n_layers} layers")
        # per-row adaptive depth: seeded at max_k, dropped with the row
        self._spec_depth: Dict[int, int] = {}
        # straggler speed factors persisted by a speed-aware replan
        self.shard_speeds: Optional[np.ndarray] = None
        self.queue: deque = deque()
        self.active: Dict[int, Request] = {}  # row -> request
        self.freelist = RowFreelist(scfg.max_rows)
        self.trigger = ReplanTrigger(window=scfg.replan_window,
                                     threshold=scfg.replan_threshold,
                                     cooldown=scfg.replan_cooldown)
        self.step_idx = 0
        self.n_replans = 0
        self.n_preemptions = 0
        self.n_cancellations = 0
        self.draining = False  # set by drain(): admission stops
        self.replan_log: List[dict] = []
        self.finished: List[Request] = []
        self.step_s: List[float] = []
        self.prepare_s: List[float] = []  # host time of each tick's prepare_decode
        self.propose_s: List[float] = []  # host time of each speculative draft step
        self.verify_s: List[float] = []  # host time of each verify step
        self.decode_ticks = 0  # ticks that ran a decode step (plain or speculative)

    # ---- load accounting ---------------------------------------------------

    def per_shard_load(self) -> np.ndarray:
        """(n_shards,) realized Σ lengths per shard (the Eq. 4 observable)."""
        per_slot = self.state.cache.lengths.sum(dim=(0, 2)).cpu().numpy()
        return per_slot.reshape(self.plan.n_shards, self.plan.slots_per_shard).sum(axis=1)

    def _imbalance_from(self, load: np.ndarray) -> float:
        if self.shard_speeds is not None:
            load = load / self.shard_speeds
        mean = load.mean()
        return float(load.max() / mean) if mean > 0 else 1.0

    def imbalance(self) -> float:
        """max/mean per-shard realized load (1.0 = fair); with persisted
        ``shard_speeds`` the time imbalance load/speed."""
        return self._imbalance_from(self.per_shard_load())

    def realized_profile(self) -> np.ndarray:
        """(L, H) mean retained length per head over the active rows
        (replicas of a head own disjoint rows, so summing over its slots
        recovers each row's full per-head length)."""
        lens = self.state.cache.lengths.cpu().numpy()  # (L, S, B)
        sh = self.pa.slot_head.cpu().numpy()  # (L, S)
        L = lens.shape[0]
        rows = sorted(self.active)
        if not rows:
            raise RuntimeError("no active rows to profile")
        prof = np.zeros((L, self.plan.n_heads), dtype=np.float64)
        for h in range(self.plan.n_heads):
            contrib = np.where(sh[:, :, None] == h, lens, 0)  # (L, S, B)
            prof[:, h] = contrib[:, :, rows].sum(axis=1).mean(axis=1)
        return np.maximum(prof, 1.0)

    # ---- admission ---------------------------------------------------------

    def submit(self, req: Request) -> None:
        # fail fast on a request that could never be admitted, instead of
        # blocking the FCFS queue behind it
        reason = self.backend.never_fits(req)
        if reason is not None:
            raise ValueError(f"request {req.req_id} can never be admitted: {reason}")
        req.state = RequestState.QUEUED
        if req.arrival_time is None:
            req.arrival_time = time.time()
        self.queue.append(req)

    def admissible(self, req: Request) -> bool:
        if len(self.freelist) == 0:
            return False
        return self.backend.admissible(self.state, req)

    def _admit(self, req: Request) -> Optional[int]:
        """Prefill + splice; returns the row, or None when the backend ran
        out of memory (the caller requeues)."""
        row = self.freelist.acquire()
        req.state = RequestState.PREFILLING
        req.row = row
        req.admit_step = self.step_idx
        batch = {"tokens": torch.as_tensor(np.asarray(req.prompt, np.int64)[None, :],
                                           device=self.device)}
        sub, logits, _ = self.executor.prefill(self.sp, batch, self.pa, rows=[row])
        try:
            self.state = self.backend.splice(self.state, sub, [row])
        except PoolExhausted:
            # admission never preempts (evicting older work to admit newer
            # would invert FCFS); unreachable for the built-in backends,
            # whose admissible() charge covers the splice
            self.freelist.release(row)
            req.state = RequestState.QUEUED
            req.row = None
            req.admit_step = None
            return None
        req.generated.append(int(sub.last_tokens[0]))
        req.first_token_step = self.step_idx
        req.first_token_time = time.time()
        if self.scfg.collect_logits:
            req.logits = [logits[0].cpu().numpy()]
        req.state = RequestState.DECODING
        self.active[row] = req
        if self._done(req):
            self._retire(req)
        return row

    def _done(self, req: Request) -> bool:
        if req.n_generated >= req.max_new_tokens:
            return True
        return req.eos_id is not None and req.generated[-1] == req.eos_id

    def _release_row(self, req: Request) -> None:
        """Free a live request's row and its storage (retirement,
        cancellation and preemption share it)."""
        row = req.row
        self.state = self.backend.release_rows(self.state, [row])
        del self.active[row]
        self._spec_depth.pop(row, None)
        self.freelist.release(row)

    def _retire(self, req: Request) -> None:
        self._release_row(req)
        req.state = RequestState.FINISHED
        req.finish_step = self.step_idx
        req.finish_time = time.time()
        req.row = None
        self.finished.append(req)

    # ---- cancellation + draining -------------------------------------------

    @torch.inference_mode()
    def cancel(self, req_id: int) -> bool:
        """Retire a request early (client disconnect, deadline shed): a live
        row is released like a normal retirement, a queued request is
        dropped.  It lands in ``finished`` as CANCELLED.  False when the id
        is unknown or already finished."""
        req = next((r for r in self.active.values() if r.req_id == req_id), None)
        if req is not None:
            self._release_row(req)
        else:
            req = next((r for r in self.queue if r.req_id == req_id), None)
            if req is None:
                return False
            self.queue.remove(req)
        req.state = RequestState.CANCELLED
        req.finish_step = self.step_idx
        req.finish_time = time.time()
        req.row = None
        self.finished.append(req)
        self.n_cancellations += 1
        return True

    def drain(self) -> None:
        """Graceful shutdown: stop admitting, finish decoding live rows
        (`run` cancels the queue and the unsubmitted arrivals)."""
        self.draining = True

    # ---- preemption --------------------------------------------------------

    def _evict(self, victim: Request) -> None:
        """Preempt one live request back to the front of the queue
        (recompute policy), freeing its row and blocks."""
        self._release_row(victim)
        victim.reset_for_requeue()
        self.queue.appendleft(victim)
        self.n_preemptions += 1

    def _preempt_one(self) -> bool:
        """Evict the least urgent, then youngest, active request (the most
        recently admitted has the least progress to replay).  False when
        nothing is left to evict."""
        victims = list(self.active.values())
        if not victims:
            return False
        self._evict(max(victims, key=lambda r: (r.priority, r.admit_step, r.req_id)))
        return True

    def _prepare_decode(self, n_tokens: int = 1) -> None:
        """Backend pre-tick hook with preemption: every active row's next
        ``n_tokens`` appends must have storage; evict while the pool is
        dry."""
        t0 = time.perf_counter()
        while True:
            try:
                self.state = self.backend.prepare_decode(
                    self.state, sorted(self.active), n_tokens=n_tokens)
                self.prepare_s.append(time.perf_counter() - t0)
                return
            except PoolExhausted as e:
                if not self._preempt_one():
                    raise RuntimeError(
                        "cache pool exhausted with nothing left to preempt "
                        "— the pool is too small for a single request "
                        f"({e}); raise PagingConfig.n_blocks") from e

    # ---- replanning --------------------------------------------------------

    def should_replan(self) -> bool:
        """Trigger armed and enough live rows for a meaningful profile."""
        return (self.scfg.enable_replan
                and len(self.active) >= self.scfg.replan_min_rows
                and self.trigger.ready(self.step_idx))

    @staticmethod
    def _imbalance_of(lengths: np.ndarray, n_shards: int, slots_per_shard: int,
                      shard_speeds: Optional[Sequence[float]] = None) -> float:
        """max/mean per-shard load; with ``shard_speeds`` load_j / speed_j."""
        per_slot = np.asarray(lengths).sum(axis=(0, 2))
        load = per_slot.reshape(n_shards, slots_per_shard).sum(axis=1)
        if shard_speeds is not None:
            load = load / np.asarray(shard_speeds, float)
        mean = load.mean()
        return float(load.max() / mean) if mean > 0 else 1.0

    def replan(self, profile: Optional[np.ndarray] = None,
               shard_speeds: Optional[Sequence[float]] = None) -> dict:
        """Plan again and migrate the live cache and weights into the new
        slot layout, if that helps.

        Default input: the realized per-head profile of the active rows;
        ``profile`` overrides it, ``shard_speeds`` plans against
        heterogeneous shards (and persists for later replans).  The
        candidate is scored on its realized lengths after migration and
        rejected (no state change, cooldown still consumed) unless it
        strictly lowers the per-shard imbalance.
        """
        with torch.inference_mode():
            return self._replan_impl(profile, shard_speeds)

    def _replan_impl(self, profile, shard_speeds) -> dict:
        if shard_speeds is not None:
            self.shard_speeds = np.asarray(shard_speeds, float)
        speeds = self.shard_speeds
        before = self._imbalance_of(self.state.cache.lengths.cpu().numpy(),
                                    self.plan.n_shards, self.plan.slots_per_shard,
                                    speeds)
        profile = (self.realized_profile() if profile is None
                   else np.asarray(profile, np.float64))
        new_plan = build_plan(profile, self.plan.n_shards, self.pcfg,
                              shard_speeds=speeds)
        new_pa = PlanArrays.from_plan(new_plan, device=self.device)
        try:
            cand_lengths, commit = self.backend.migrate_cache(
                self.state.cache, self.pa, new_pa, active_rows=sorted(self.active))
        except PoolExhausted as e:
            # block rounding under the new ownership does not fit the pool
            event = {"step": self.step_idx, "imbalance_before": before,
                     "imbalance_after": before, "accepted": False,
                     "rejected_reason": f"pool exhausted: {e}"}
            self.replan_log.append(event)
            return event
        after = self._imbalance_of(cand_lengths.cpu().numpy(), new_plan.n_shards,
                                   new_plan.slots_per_shard, speeds)
        event = {"step": self.step_idx, "imbalance_before": before,
                 "imbalance_after": after, "accepted": after < before - 1e-9}
        if not event["accepted"]:
            event["imbalance_after"] = before
            self.replan_log.append(event)
            return event
        self.state.cache = commit()
        self.plan, self.pa = new_plan, new_pa
        self.sp = slotify_params(self.params, new_plan, self.cfg)
        self.n_replans += 1
        self.replan_log.append(event)
        return event

    # ---- main loop ---------------------------------------------------------

    def active_mask(self) -> torch.Tensor:
        m = torch.zeros(self.scfg.max_rows, dtype=torch.bool)
        m[sorted(self.active)] = True
        return m.to(self.device)

    def _retire_done(self, events: dict) -> None:
        for row in sorted(self.active):
            req = self.active[row]
            if self._done(req):
                self._retire(req)
                events["finished"].append(req.req_id)

    def _decode_tick(self, events: dict) -> None:
        """One single-token decode tick over the live rows."""
        self._prepare_decode()  # may preempt (paged pool dry)
        if not self.active:  # everything got preempted
            return
        self.state, logits = self.executor.decode(
            self.sp, self.state, self.pa, self.state.last_tokens,
            active=self.active_mask())
        self.decode_ticks += 1
        toks = self.state.last_tokens.cpu().numpy()
        logits_np = logits.cpu().numpy() if self.scfg.collect_logits else None
        for row in sorted(self.active):
            req = self.active[row]
            req.generated.append(int(toks[row]))
            if logits_np is not None:
                req.logits.append(logits_np[row])
        self._retire_done(events)

    # ---- speculative decoding ----------------------------------------------

    def _spec_depths(self) -> np.ndarray:
        """(max_rows,) speculation depth for this tick: the per-request
        adaptive depth clamped by the tokens left (a row never proposes past
        its own ``max_new_tokens``) and by cache headroom (an at-capacity
        row degrades to a window of 1, plain decode)."""
        depth = np.zeros(self.scfg.max_rows, np.int32)
        lens = self.state.cache.lengths.cpu().numpy()
        cap = self.backend.capacity
        for row, req in self.active.items():
            want = self._spec_depth.setdefault(row, self.spec.max_k)
            remaining = req.max_new_tokens - req.n_generated
            headroom = cap - int(lens[:, :, row].max())
            depth[row] = max(0, min(want, remaining - 1, headroom - 1))
        return depth

    def _decode_tick_speculative(self, events: dict) -> None:
        """One speculative tick: propose up to k draft tokens per row, one
        multi-query verify pass, commit the accepted run (1..k+1 tokens).

        `prepare_decode(n_tokens=...)` reserves the whole window's blocks up
        front (preempting if the pool is dry); after verify, `trim_rows`
        returns every block past the committed lengths to the pool."""
        spec = self.spec
        d = spec.draft_layers if spec.draft_layers > 0 else self.cfg.n_layers
        depth = self._spec_depths()
        self._prepare_decode(n_tokens=int(depth.max()) + 1)
        if not self.active:  # everything got preempted reserving blocks
            return
        mask = self.active_mask()
        t0 = time.perf_counter()
        st, props = self.executor.propose(
            self.sp, self.state, self.pa, torch.as_tensor(depth, device=self.device),
            active=mask, draft_layers=d, max_k=spec.max_k)
        t1 = time.perf_counter()
        tokens = torch.cat([st.last_tokens[:, None], props], dim=1)
        q_lens = torch.as_tensor(depth + 1, dtype=torch.int32, device=self.device)
        st, g, n_commit, logits = self.executor.verify(
            self.sp, st, self.pa, tokens, q_lens, active=mask, draft_layers=d)
        self.propose_s.append(t1 - t0)
        self.verify_s.append(time.perf_counter() - t1)
        self.decode_ticks += 1
        self.state = self.backend.trim_rows(st, sorted(self.active))
        g_np, nc = g.cpu().numpy(), n_commit.cpu().numpy()
        logits_np = logits.cpu().numpy() if self.scfg.collect_logits else None
        for row in sorted(self.active):
            req = self.active[row]
            n, prop = int(nc[row]), int(depth[row])
            req.spec_proposed += prop
            req.spec_accepted += max(0, n - 1)
            # commit the accepted run, cut at EOS / max_new_tokens (the
            # cache may hold a few tokens past the cut; the row retires
            # right below, which frees them with the row)
            for i in range(n):
                req.generated.append(int(g_np[row, i]))
                if logits_np is not None:
                    req.logits.append(logits_np[row, i])
                if self._done(req):
                    break
            if spec.adaptive and prop > 0:
                alpha = (n - 1) / prop
                want = self._spec_depth[row]
                if alpha < spec.low_acceptance:
                    self._spec_depth[row] = max(spec.min_k, want - 1)
                elif alpha >= spec.high_acceptance:
                    self._spec_depth[row] = min(spec.max_k, want + 1)
        self._retire_done(events)

    @torch.inference_mode()
    def step(self) -> dict:
        """One tick: admit → decode → retire → (maybe) replan."""
        t0 = time.perf_counter()
        events: dict = {"step": self.step_idx, "admitted": [], "finished": [],
                        "preempted": 0, "replanned": False}
        preempted_before = self.n_preemptions
        # admission: best (priority, FIFO) first; with equal priorities this
        # is strict FCFS (preempted victims re-enter at the front).  The
        # chosen request gates admission, so a large urgent one is never
        # starved by smaller later ones.
        while self.queue and not self.draining:
            i = min(range(len(self.queue)), key=lambda j: (self.queue[j].priority, j))
            req = self.queue[i]
            if not self.admissible(req):
                break
            del self.queue[i]
            row = self._admit(req)
            if row is None:  # backend memory dry
                self.queue.appendleft(req)
                break
            events["admitted"].append((req.req_id, row))
            if req.is_finished:  # max_new_tokens == 1 or instant EOS
                events["finished"].append(req.req_id)
        # one decode tick for every live row: speculative (draft proposals
        # + one multi-query verify) when configured, single-token otherwise
        if self.active and self.spec is not None:
            self._decode_tick_speculative(events)
        elif self.active:
            self._decode_tick(events)
        events["preempted"] = self.n_preemptions - preempted_before
        self.trigger.observe(self.imbalance())
        if self.should_replan():
            self.trigger.fire(self.step_idx)
            events["replan"] = self.replan()
            events["replanned"] = True
        self.step_idx += 1
        self.step_s.append(time.perf_counter() - t0)
        return events

    def run(self, requests: Sequence[Request], max_steps: int = 10_000) -> dict:
        """Drive a trace: submit each request at its ``arrival_step``, tick
        until every request is finished (or ``max_steps``).  Returns the
        summary telemetry."""
        pending = sorted(requests, key=lambda r: (r.arrival_step, r.req_id))
        n_total = len(pending)
        i = 0
        first_decode_step: Optional[int] = None
        mid_stream_admissions = 0
        t0 = time.time()
        while len(self.finished) < n_total and self.step_idx < max_steps:
            if self.draining:
                # cancel everything not decoding, then finish the live rows
                for req in list(self.queue):
                    self.cancel(req.req_id)
                while i < len(pending):
                    pending[i].state = RequestState.CANCELLED
                    self.finished.append(pending[i])
                    self.n_cancellations += 1
                    i += 1
                if not self.active:
                    break
            while (not self.draining and i < len(pending)
                   and pending[i].arrival_step <= self.step_idx):
                self.submit(pending[i])
                i += 1
            ev = self.step()
            if ev["admitted"] and first_decode_step is not None:
                mid_stream_admissions += len(ev["admitted"])
            if (self.active or ev["finished"]) and first_decode_step is None:
                first_decode_step = ev["step"]
        wall = time.time() - t0
        total_tokens = sum(r.n_generated for r in self.finished)
        proposed = sum(r.spec_proposed for r in self.finished)
        accepted = sum(r.spec_accepted for r in self.finished)
        return {
            "steps": self.step_idx,
            "decode_ticks": self.decode_ticks,
            "wall_s": wall,
            "finished": len(self.finished),
            "total": n_total,
            "generated_tokens": total_tokens,
            "mid_stream_admissions": mid_stream_admissions,
            "replans": self.n_replans,
            "replan_log": list(self.replan_log),
            "preemptions": self.n_preemptions,
            "cancelled": sum(1 for r in self.finished if r.cancelled),
            "drained": self.draining,
            "latency": latency_percentiles([r for r in self.finished if not r.cancelled]),
            "memory": self.backend.memory_stats(self.state),
            "tokens_per_s": total_tokens / wall if wall > 0 else 0.0,
            "spec_proposed": proposed,
            "spec_accepted": accepted,
            "acceptance": accepted / proposed if proposed else None,
        }
