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

On the multi-GPU executor's mesh every rank runs this scheduler on the same
host data: rows, tokens and lengths are global on every rank (the backend's
`host_lengths` gathers the sharded lengths the same way on all of them),
so the ranks decide alike; each rank's device state is its shard.  There
is no prefix index on a partitioned pool: a shared block lives on its
donor's rank and cannot back another rank's rows.

Chunked prefill (``PrefixConfig.chunk_tokens`` > 0): a prompt longer than
one chunk reserves its row and runs one chunk per tick in a private B = 1
sub-state, so live rows keep decoding between its chunks; the final chunk
splices it in.  Prefix reuse (``PrefixConfig.enabled``, paged backend):
the full-chunk boundaries of finished prompts enter a content-addressed
index (`repro_torch.prefix.PrefixIndex`); a later prompt that starts with
the same tokens seeds its sub-state from the longest matching boundary,
skips those chunks, and maps the shared blocks into its row instead of
copying them.  Index-only entries are the first memory reclaimed when the
pool runs dry, before any preemption.

The SSM and hybrid families carry each row's SSD and conv state beside
the cache: a splice writes a request's rows of it, a retirement zeroes
them, and a preempted request's replay rebuilds them from its prompt plus
its earlier tokens, fed back one decode step at a time.  An attention-free
model (mamba2) has no cache: nothing to balance (``imbalance()`` is 1.0)
and no placement to replan.  Chunked prefill falls back to monolithic
prefill for every family but the dense one.  Encoder-decoder and VLM
models are refused: their prompts are not token sequences alone.

Observability (``obs``, the engine's `repro_torch.obs.Obs`; `NULL_OBS`
when constructed alone): the reference's series under the reference's
names — admissions, retirements, preemptions, cancellations and replans
by outcome; per tick the per-shard realized load (``shard_load_tokens``,
Eq. 4), ``sched_imbalance``, rows, queue depth and prefix census, with the
backend's pool gauges; the plan's projected load; speculation counters;
TTFT / ITL / end-to-end histograms; and trace spans around admission,
chunks, decode ticks and replans.  All host-side, between steps.
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.cache.slot_cache import PlanArrays, copy_fields_, init_cache
from repro_torch.compression.base import CompressionConfig
from repro_torch.compression.policies import layer_keep_bound
from repro_torch.configs.base import ModelConfig
from repro_torch.core.placement import HeadPlacement
from repro_torch.core.planner import PlannerConfig, build_plan
from repro_torch.exec.base import Executor
from repro_torch.obs import NULL_OBS, Obs
from repro_torch.paging.block_pool import PoolExhausted
from repro_torch.paging.paged_cache import PagedCache, paged_to_slot
from repro_torch.prefix import PrefixConfig, PrefixEntry, PrefixIndex
from repro_torch.serving.cache_backend import CacheBackend, make_cache_backend
from repro_torch.serving.engine import _spec_supported, init_serve_state, slotify_params
from repro_torch.serving.quant import has_qtensor
from repro_torch.serving.request import Request, RequestState, latency_percentiles
from repro_torch.serving.speculation import SpeculationConfig


class RowFreelist:
    """Free batch rows, handed out lowest index first (deterministic)."""

    def __init__(self, n_rows: int):
        self.n_rows = n_rows
        self._free = list(range(n_rows))

    def __len__(self) -> int:
        return len(self._free)

    @property
    def in_use(self) -> int:
        return self.n_rows - len(self._free)

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
class _ChunkJob:
    """One chunked prefill in flight: the request sits in PREFILLING with
    its row reserved while `Scheduler.step` advances its private B = 1
    sub-state one chunk per tick.  It holds no block of the live state
    until the final chunk splices (atomic on PoolExhausted), so aborting it
    only unwinds the row, the pin and the request state."""

    req: Request
    row: int
    prompt: np.ndarray
    state: object  # B = 1 ServeState accumulating the retained chunks
    next_pos: int = 0  # absolute position of the next chunk's first token
    entry: Optional[PrefixEntry] = None  # pinned seed entry on a prefix hit
    seed_tokens: int = 0  # tokens covered by the seed (0 = cold start)
    # full-chunk boundary -> (L, H) cumulative retained lengths, taken as
    # each chunk lands (the donor's input to index registration)
    boundaries: Dict[int, np.ndarray] = field(default_factory=dict)
    last_logits: Optional[np.ndarray] = None


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
    (block allocation and table copy; preemptions included), ``chunk_s``
    that of each chunked-prefill step, and with speculation on
    ``propose_s`` / ``verify_s`` those of each tick's draft and verify
    steps.
    """

    def __init__(self, cfg: ModelConfig, params: dict, plan: HeadPlacement,
                 ccfg: CompressionConfig, scfg: SchedulerConfig,
                 executor: Executor, planner_cfg: Optional[PlannerConfig] = None,
                 dtype=torch.float32, serve_params: Optional[dict] = None,
                 backend: Optional[CacheBackend] = None,
                 spec_cfg: Optional[SpeculationConfig] = None,
                 prefix_cfg: Optional[PrefixConfig] = None,
                 head_importance: Optional[np.ndarray] = None,
                 obs: Optional[Obs] = None,
                 plan_profile: Optional[np.ndarray] = None):
        if cfg.is_encoder_decoder or cfg.is_vlm:
            raise NotImplementedError(
                "continuous batching supports token-prompt decoder models")
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
        # the slots whose weights and cache this process holds (a mesh
        # rank's share of the slot dim; every slot on one device)
        self._slots = executor.local_slots(plan.n_shards * plan.slots_per_shard)
        with torch.inference_mode():
            self.sp = (serve_params if serve_params is not None
                       else slotify_params(params, plan, cfg, slots=self._slots))
        self.backend = backend if backend is not None else make_cache_backend(
            "slot", cfg, ccfg, max_live_tokens=scfg.max_live_tokens,
            n_shards=plan.n_shards,
            max_live_tokens_per_shard=scfg.max_live_tokens_per_shard)
        # per-head weights of the importance-driven policy (headkv):
        # admission prefills compress with the budgets the profile was
        # measured under.  One (L, Hkv) device tensor, made once, which
        # every prefill and chunk step reads (a captured chunk step copies
        # it into its input buffer per call)
        self.head_importance = head_importance
        self._head_importance = (None if head_importance is None else torch.as_tensor(
            np.asarray(head_importance), dtype=torch.float32, device=self.device))
        # one registry / trace for the stack: the backend before init_state,
        # so the paged pool is born with the live handle
        self.obs = obs if obs is not None else NULL_OBS
        if obs is not None:
            self.backend.obs = self.obs
            self.executor.obs = self.obs
        # the per-head profile the current plan was planned from (the
        # shard_projected_load gauge); refreshed on every accepted replan
        self.plan_profile = (None if plan_profile is None
                             else np.asarray(plan_profile, np.float64))
        with torch.inference_mode():
            self.state = self.backend.init_state(self.pa, scfg.max_rows, dtype)
        # chunked prefill needs only the dense-attention chunk step; block
        # sharing also needs the paged backend's refcounted pool
        self.prefix_cfg = prefix_cfg if prefix_cfg is not None else PrefixConfig()
        self.prefilling: Dict[int, _ChunkJob] = {}  # row -> job in flight
        self._chunk_ok = (self.prefix_cfg.chunk_tokens > 0 and cfg.family == "dense"
                          and not cfg.attention_free)
        self.prefix: Optional[PrefixIndex] = None
        if (self.prefix_cfg.enabled and self._chunk_ok and self.backend.name == "paged"
                and self.backend.pool.n_partitions == 1):
            self.prefix = PrefixIndex(self.prefix_cfg.chunk_tokens,
                                      self.prefix_cfg.max_entries, obs=self.obs)
            self.prefix.pool = self.backend.pool
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
        self.chunk_s: List[float] = []  # host time of each chunked-prefill step
        self.decode_ticks = 0  # ticks that ran a decode step (plain or speculative)
        if self.obs.enabled:
            # pre-register the outcome series, so exports show explicit zeros
            c = self.obs.metrics.counter(
                "sched_replans_total",
                help="replan attempts by outcome (accepted replans migrated "
                     "the live cache; rejected left state untouched)")
            c.inc(0, outcome="accepted")
            c.inc(0, outcome="rejected")
            self._sample_plan_metrics()

    # ---- load accounting ---------------------------------------------------

    def lengths(self) -> np.ndarray:
        """The live cache's (L, S, B) retained lengths on the host (on a mesh
        gathered, the same on every rank)."""
        return self.backend.host_lengths(self.state)

    def live_tokens(self) -> int:
        """Σ retained lengths over the whole live cache (all layers, slots
        and rows)."""
        return int(self.lengths().sum())

    def per_shard_load(self) -> np.ndarray:
        """(n_shards,) realized Σ lengths per shard (the Eq. 4 observable)."""
        per_slot = self.lengths().sum(axis=(0, 2))
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

    # ---- observability sampling --------------------------------------------

    def _sample_plan_metrics(self) -> None:
        """Gauge the projected per-shard load of the current plan under the
        profile it was planned from: the planner's promise, against which
        ``shard_load_tokens`` shows the realized load."""
        if self.plan_profile is None:
            return
        g = self.obs.metrics.gauge(
            "shard_projected_load",
            help="planner-projected per-shard load of the active placement "
                 "under the profile it was planned from")
        for s, v in enumerate(self.plan.per_shard_load(self.plan_profile)):
            g.set(float(v), shard=str(s))

    def _sample_step_metrics(self, load: np.ndarray, imb: float) -> None:
        """Per-tick gauges (host-side; called only when obs is on)."""
        m = self.obs.metrics
        g = m.gauge("shard_load_tokens",
                    help="realized Σ retained KV tokens per model shard "
                         "(the paper's Eq. 4 observable)")
        for s, v in enumerate(load):
            g.set(float(v), shard=str(s))
        m.gauge("sched_imbalance",
                help="max/mean per-shard realized load (1.0 = fair); "
                     "speed-normalized under persisted shard_speeds").set(imb)
        m.gauge("sched_active_rows",
                help="batch rows holding a live request").set(len(self.active))
        m.gauge("sched_queue_depth",
                help="requests waiting in the FCFS queue").set(len(self.queue))
        m.gauge("sched_prefilling_rows",
                help="rows held by in-flight chunked prefills "
                     "(DESIGN.md §14)").set(len(self.prefilling))
        if self.prefix is not None:
            st = self.prefix.stats()
            m.gauge("prefix_entries",
                    help="prompt-prefix boundaries held by the index").set(
                st["entries"])
            m.gauge("prefix_shared_blocks",
                    help="pool blocks referenced by prefix entries").set(
                st["blocks_held"])
            # every reference beyond the first on an allocated block is a
            # block the sharing rows would otherwise each hold privately
            extra = int(np.maximum(self.backend.pool.refcount - 1, 0).sum())
            c = self.state.cache
            blk_bytes = 2 * c.k_pool.shape[2] * c.k_pool.shape[3] * c.k_pool.element_size()
            m.gauge("prefix_bytes_saved",
                    help="KV bytes deduplicated by prefix sharing "
                         "(Σ (refcount−1) · block bytes)").set(extra * blk_bytes)
        self.backend.sample_metrics(self.state)
        pe = self.obs.cfg.print_every
        if pe > 0 and self.step_idx % pe == 0:
            print(f"[obs] step={self.step_idx} active={len(self.active)} "
                  f"queued={len(self.queue)} finished={len(self.finished)} "
                  f"imbalance={imb:.3f} preemptions={self.n_preemptions} "
                  f"replans={self.n_replans}", flush=True)

    def _count_admission(self, req: Request) -> None:
        """The admission counter and the request's TTFT sample."""
        self.obs.metrics.counter(
            "sched_admissions_total",
            help="requests admitted (prefilled + spliced)").inc()
        ttft = req.ttft_seconds()
        if ttft is not None:
            self.obs.metrics.histogram(
                "ttft_s", help="time to first token (queue wait + prefill "
                               "wall time)").observe(ttft)

    def realized_profile(self) -> np.ndarray:
        """(L, H) mean retained length per head over the active rows
        (replicas of a head own disjoint rows, so summing over its slots
        recovers each row's full per-head length)."""
        lens = self.lengths()  # (L, S, B)
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

    def _estimated_cost(self, req: Request) -> int:
        """Projected cost in the backend's units (slot: Σ-lengths bound from
        the policy's keep bound; paged: worst-case blocks)."""
        return self.backend.request_cost(req)

    def admissible(self, req: Request) -> bool:
        if len(self.freelist) == 0:
            return False
        # chunked prefills in flight hold rows but no blocks until their
        # final splice: charge them as pending, so admission does not
        # promise the same free blocks twice
        pending = [j.req for j in self.prefilling.values()]
        return self.backend.admissible(self.state, req, pending=pending)

    def _admit(self, req: Request) -> Optional[int]:
        """Prefill + splice; returns the row, or None when the backend ran
        out of memory (the caller requeues)."""
        row = self.freelist.acquire()
        req.state = RequestState.PREFILLING
        req.row = row
        req.admit_step = self.step_idx
        batch = {"tokens": torch.as_tensor(np.asarray(req.prompt, np.int64)[None, :],
                                           device=self.device)}
        sub, logits, _ = self.executor.prefill(self.sp, batch, self.pa, rows=[row],
                                               head_importance=self._head_importance)
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
        self._commit(req, row, int(sub.last_tokens[0]))
        req.first_token_step = self.step_idx
        req.first_token_time = time.time()
        self._count_admission(req)
        if self.scfg.collect_logits:
            req.logits = [logits[0].cpu().numpy()]
        req.state = RequestState.DECODING
        self.active[row] = req
        if self._done(req):
            self._retire(req)
        return row

    def _commit(self, req: Request, row: int, tok: int) -> None:
        """Append ``row``'s new token ``tok`` to ``req``; a replay appends
        the token it produced before its preemption instead and makes it
        the row's next input."""
        k = req.n_generated
        if k < len(req.replay) and req.replay[k] != tok:
            tok = req.replay[k]
            self.state.last_tokens[row] = tok
            self.obs.metrics.counter(
                "sched_replay_swaps_total",
                help="tokens a replay computed otherwise than before its "
                     "preemption (the earlier token is kept)").inc()
        req.generated.append(tok)

    def _done(self, req: Request) -> bool:
        if req.n_generated >= req.max_new_tokens:
            return True
        return req.eos_id is not None and req.generated[-1] == req.eos_id

    # ---- chunked prefill + prefix sharing ----------------------------------

    def _should_chunk(self, req: Request) -> bool:
        """Prompts longer than one chunk take the chunked path; a prompt
        that fits in one chunk gains nothing from it."""
        return self._chunk_ok and req.prompt_len > self.prefix_cfg.chunk_tokens

    def _stamp_prefix_hit(self, req: Request) -> Optional[PrefixEntry]:
        """Look up the longest shared prefix and stamp the request's
        admission discount (``prefix_shared_blocks``); returns the entry,
        so admission seeds from it without a second lookup."""
        if self.prefix is None or not self._should_chunk(req):
            req.prefix_shared_blocks = None
            return None
        entry = self.prefix.lookup(np.asarray(req.prompt, np.int32))
        if entry is None:
            req.prefix_shared_blocks = None
            req.prefix_hit_tokens = 0
            return None
        req.prefix_hit_tokens = entry.tokens
        full = np.asarray(entry.lengths) // self.backend.block_size  # (L, H)
        req.prefix_shared_blocks = full.sum(axis=1).astype(np.int64)
        return entry

    def _reclaim_for(self, req: Request, entry: Optional[PrefixEntry]):
        """Nothing is live, so nothing will free blocks but the index:
        evict its LRU entries until ``req`` is admissible (or none is left)
        and return its hit, stamped again if the entry it matched went.
        Without this an index holding the pool would stall admission for
        good (the reference does: ROADMAP C.5)."""
        while self.prefix is not None and not self.admissible(req):
            if not self.prefix.evict_lru():
                break
            if entry is not None and entry.key not in self.prefix._entries:
                entry = self._stamp_prefix_hit(req)
        return entry

    def _owned_heads(self, row: int):
        """(l, s, head) of every slot that owns ``row`` (the strided owner
        rule), in (layer, slot) order."""
        sh = self.pa.slot_head.cpu().numpy()
        ri = self.pa.replica_idx.cpu().numpy()
        rc = self.pa.replica_count.cpu().numpy()
        own = (sh >= 0) & ((row % np.maximum(rc, 1)) == ri)  # (L, S)
        return [(int(l), int(s), int(sh[l, s])) for l, s in zip(*np.nonzero(own))]

    def _head_slot_table(self, entry: PrefixEntry, row: int):
        """Map an entry's head-indexed blocks onto the slots that own each
        head for this row → ((L, S, 1, M) ids, (L, S, 1) lengths).
        Replicas of a head serve disjoint rows, so donor and recipient may
        keep one head in different slots; block content is per head, so
        that is only a table rewrite."""
        L, S = self.pa.slot_head.shape
        M = self.backend.max_blocks
        tbl = np.zeros((L, S, 1, M), np.int32)
        lens = np.zeros((L, S, 1), np.int32)
        n = min(entry.table.shape[2], M)
        for layer, s, h in self._owned_heads(row):
            tbl[layer, s, 0, :n] = entry.table[layer, h, :n]
            lens[layer, s, 0] = entry.lengths[layer, h]
        return tbl, lens

    def _seed_from_entry(self, entry: PrefixEntry, row: int):
        """A fresh B = 1 sub-state holding a matched prefix.

        The entry's blocks are viewed through a one-row table and gathered
        with `paged_to_slot`: a copy, so the shared blocks are read, never
        aliased; the final splice maps the same blocks back into the row's
        table without writing them.  Quantized pools dequantize through the
        live scales into the model dtype, as a replan's migration does (the
        reference's seed gathers the raw codes: ROADMAP C.4)."""
        live = self.state.cache
        tbl, lens = self._head_slot_table(entry, row)
        view = PagedCache(
            k_pool=live.k_pool, v_pool=live.v_pool, pos_pool=live.pos_pool,
            block_table=torch.as_tensor(tbl, device=self.device),
            lengths=torch.as_tensor(lens, device=self.device),
            positions=torch.full((1,), entry.tokens, dtype=torch.int32,
                                 device=self.device),
            k_scale=live.k_scale, v_scale=live.v_scale)
        slot = paged_to_slot(view, self.backend.capacity,
                             kinds=self.backend._slot_kinds(self.pa),
                             out_dtype=self.dtype)
        return init_serve_state(self.cfg, self.pa, 1, self.ccfg, dtype=self.dtype,
                                device=self.device, cache=slot)

    def sub_state(self, batch: int = 1):
        """An empty ``batch``-row slot sub-state for a chunked prefill: this
        process's slots, every row."""
        return init_serve_state(self.cfg, self.pa, batch, self.ccfg, dtype=self.dtype,
                                device=self.device, cache=init_cache(
                                    self.cfg.n_layers, self._slots.stop - self._slots.start,
                                    batch, self.ccfg.static_capacity(), self.cfg.head_dim,
                                    dtype=self.dtype, device=self.device))

    def _start_chunked(self, req: Request, entry: Optional[PrefixEntry]) -> int:
        """Begin a chunked prefill: reserve the row, seed from the matched
        prefix boundary (if any) and leave the job in ``prefilling``;
        `step` advances it one chunk per tick, so decode ticks of live rows
        interleave instead of stalling behind a long prompt."""
        row = self.freelist.acquire()
        req.state = RequestState.PREFILLING
        req.row = row
        req.admit_step = self.step_idx
        if entry is not None:
            sub = self._seed_from_entry(entry, row)
            self.prefix.pin(entry)  # immune to eviction while it is read
            start = entry.tokens
        else:
            sub = self.sub_state()
            start = 0
        self.prefilling[row] = _ChunkJob(
            req=req, row=row, prompt=np.asarray(req.prompt, np.int32), state=sub,
            next_pos=start, entry=entry, seed_tokens=start)
        return row

    def _chunk_quota(self, T: int, n: int) -> np.ndarray:
        """(L,) per-head keep cap of an ``n``-token chunk of a ``T``-token
        prompt: the monolithic per-head bound prorated by the chunk's share
        of the prompt (at least 1, so every chunk may keep something).  The
        chunks' union then tracks the monolithic budget to within a block
        of rounding per chunk; exact for policy "none"."""
        H, L = self.cfg.n_kv_heads, self.cfg.n_layers
        full = np.asarray([layer_keep_bound(self.ccfg.policy, self.ccfg, T, H, layer, L)
                           // H for layer in range(L)], np.int64)
        return np.maximum(1, np.ceil(full * n / T)).astype(np.int32)

    def _run_chunks(self, events: dict) -> None:
        """Advance every chunked prefill in flight by exactly one chunk: a
        live row's decode latency is bounded by one chunk plus one decode
        step, never a whole prefill."""
        Ck = self.prefix_cfg.chunk_tokens
        for row in sorted(self.prefilling):
            job = self.prefilling[row]
            T = int(job.prompt.shape[0])
            n = min(Ck, T - job.next_pos)
            chunk = np.zeros((1, Ck), np.int64)
            chunk[0, :n] = job.prompt[job.next_pos:job.next_pos + n]
            t0 = time.perf_counter()
            with self.obs.trace.span("prefill_chunk", req=job.req.req_id,
                                     start=job.next_pos, tokens=n):
                job.state, logits, lens = self.executor.prefill_chunk(
                    self.sp, chunk, self.pa, job.state, rows=[row],
                    start=[job.next_pos], valid=[n], quota=self._chunk_quota(T, n),
                    head_importance=self._head_importance)
            self.chunk_s.append(time.perf_counter() - t0)
            job.next_pos += n
            if n == Ck:  # a full-chunk boundary: keep it for registration
                job.boundaries[job.next_pos] = lens[:, :, 0].cpu().numpy()
            if job.next_pos >= T:
                job.last_logits = logits.cpu().numpy()
                self._finish_chunked(job, events)

    def _finish_chunked(self, job: _ChunkJob, events: dict) -> None:
        """The final chunk landed: splice the sub-state into the live batch
        (sharing the seed's blocks), stamp the first token (TTFT spans
        every chunk: submit to here) and register the prompt's boundaries
        as new prefix entries."""
        req, row = job.req, job.row
        shared = None
        if job.entry is not None:
            shared, _ = self._head_slot_table(job.entry, row)
        while True:
            try:
                if shared is None:
                    self.state = self.backend.splice(self.state, job.state, [row])
                else:
                    self.state = self.backend.splice(self.state, job.state, [row],
                                                     shared_blocks=shared)
                break
            except PoolExhausted:
                # the cheapest memory first: entries only the index holds
                if self.prefix is not None and self.prefix.evict_lru():
                    continue
                self._abort_job(job, requeue=True)
                return
        del self.prefilling[row]
        if job.entry is not None:
            self.prefix.unpin(job.entry)
        self._commit(req, row, int(job.state.last_tokens[0]))
        req.first_token_step = self.step_idx
        req.first_token_time = time.time()
        self._count_admission(req)
        if self.scfg.collect_logits:
            req.logits = [job.last_logits[0]]
        req.state = RequestState.DECODING
        self.active[row] = req
        # register before any retirement: entries take their references off
        # the row's table, which release_rows clears
        self._register_boundaries(job)
        if self._done(req):
            self._retire(req)
            events["finished"].append(req.req_id)

    def _abort_job(self, job: _ChunkJob, requeue: bool) -> None:
        """Unwind a job whose splice never landed: it holds no blocks, so
        only the row, the pin and the request state roll back."""
        del self.prefilling[job.row]
        if job.entry is not None:
            self.prefix.unpin(job.entry)
        self.freelist.release(job.row)
        req = job.req
        req.row = None
        if requeue:
            req.state = RequestState.QUEUED
            req.admit_step = None
            req.generated = []
            req.prefix_shared_blocks = None
            req.prefix_hit_tokens = 0
            self.queue.appendleft(req)

    def _register_boundaries(self, job: _ChunkJob) -> None:
        """The donor's side of the index: adopt the prompt's full-chunk
        boundaries.  An entry keeps full blocks only, its lengths cut to
        the block-aligned prefix: the partial tail block stays private to
        the row (its later appends would leak into sharers), and a later
        hit recomputes what was cut."""
        if self.prefix is None:
            return
        bs = self.backend.block_size
        L, H, M = self.cfg.n_layers, self.cfg.n_kv_heads, self.backend.max_blocks
        owned = self._owned_heads(job.row)
        for t_j, key in self.prefix.chain_keys(job.prompt):
            if t_j <= job.seed_tokens or t_j not in job.boundaries:
                continue
            full = (job.boundaries[t_j] // bs) * bs  # (L, H) block-aligned
            if not full.any():
                continue
            table = np.zeros((L, H, M), np.int32)
            for layer, s, h in owned:
                nb = int(full[layer, h]) // bs
                if nb:
                    table[layer, h, :nb] = self.backend.table[layer, s, job.row, :nb]
            self.prefix.register(key, t_j, table, full.astype(np.int32))

    def prefix_stats(self) -> dict:
        """The index's counters and entry census (empty without sharing)."""
        return {} if self.prefix is None else self.prefix.stats()

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
        m = self.obs.metrics
        m.counter("sched_retirements_total",
                  help="requests retired (EOS or max-new-tokens)").inc()
        self.obs.trace.instant("retire", req=req.req_id, n_generated=req.n_generated)
        itl = req.itl_seconds()
        if itl is not None:
            m.histogram("itl_s",
                        help="inter-token latency (per-request mean in "
                             "continuous mode; per-step in one-shot mode)"
                        ).observe(itl)
        if req.arrival_time is not None:
            m.histogram("e2e_s", help="end-to-end request latency"
                        ).observe(req.finish_time - req.arrival_time)
        if req.spec_proposed > 0:
            m.histogram("spec_acceptance",
                        help="per-request draft acceptance rate "
                             "(accepted / proposed over the lifetime)"
                        ).observe(req.spec_accepted / req.spec_proposed)

    # ---- cancellation + draining -------------------------------------------

    @torch.inference_mode()
    def cancel(self, req_id: int) -> bool:
        """Retire a request early (client disconnect, deadline shed): a live
        row is released like a normal retirement, a request mid chunked
        prefill gives back its row and pin (it holds no blocks yet), a
        queued request is dropped.  It lands in ``finished`` as CANCELLED.  False when the id
        is unknown or already finished."""
        req = next((r for r in self.active.values() if r.req_id == req_id), None)
        job = next((j for j in self.prefilling.values() if j.req.req_id == req_id),
                   None)
        if req is not None:
            self._release_row(req)
        elif job is not None:  # mid chunked prefill: no blocks held yet
            req = job.req
            self._abort_job(job, requeue=False)
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
        self.obs.metrics.counter(
            "sched_cancellations_total",
            help="requests retired early (client disconnect / deadline "
                 "shed); rows and blocks are released like a normal "
                 "retirement").inc()
        self.obs.trace.instant("cancel", req=req_id)
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
        self.obs.metrics.counter(
            "sched_preemptions_total",
            help="evictions back to QUEUED (pool exhaustion or priority "
                 "pressure), lowest-priority-youngest-first").inc()
        self.obs.trace.instant("preempt", req=victim.req_id, priority=victim.priority)

    def _preempt_one(self) -> bool:
        """Evict the least urgent, then youngest, active request (the most
        recently admitted has the least progress to replay).  False when
        nothing is left to evict."""
        victims = list(self.active.values())
        if not victims:
            return False
        self._evict(max(victims, key=lambda r: (r.priority, r.admit_step, r.req_id)))
        return True

    @torch.inference_mode()
    def preempt_lower_priority(self, than: int) -> bool:
        """Evict one active request of a strictly less urgent class than
        ``than`` (a larger priority index), the least urgent, then the
        youngest, first: the front end's lever when an urgent request waits
        behind a full batch.  False when no such request is live."""
        victims = [r for r in self.active.values() if r.priority > than]
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
                # drop index-only prefix entries before evicting live work:
                # a dropped entry may cost a recompute, a preemption costs one
                if self.prefix is not None and self.prefix.evict_lru():
                    continue
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
                and not self.prefilling  # sub-states pin the current plan
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
        strictly lowers the per-shard imbalance.  It is refused while
        chunked prefills are in flight: their sub-states are laid out under
        the current plan and their seeds read the current pool.
        """
        with torch.inference_mode(), self.obs.trace.span("replan"):
            event = self._replan_impl(profile, shard_speeds)
        # the outcome counter is the one source of replan counts
        self.obs.metrics.counter("sched_replans_total").inc(
            outcome="accepted" if event["accepted"] else "rejected")
        return event

    def _replan_impl(self, profile, shard_speeds) -> dict:
        if self.cfg.attention_free:
            raise ValueError("attention-free models have no head placement to replan")
        if shard_speeds is not None:
            self.shard_speeds = np.asarray(shard_speeds, float)
        speeds = self.shard_speeds
        before = self._imbalance_of(self.lengths(), self.plan.n_shards,
                                    self.plan.slots_per_shard, speeds)
        if self.prefilling:
            event = {"step": self.step_idx, "imbalance_before": before,
                     "imbalance_after": before, "accepted": False,
                     "rejected_reason": "chunked prefills in flight"}
            self.replan_log.append(event)
            return event
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
        # a replan is copies into the live tensors (cache, plan arrays,
        # slot weights), never new ones: captured steps keep their inputs
        self.state.cache = commit()
        self.plan = new_plan
        copy_fields_(self.pa, new_pa)
        self.backend.pa = self.pa
        quantized = has_qtensor(self.sp)
        slotify_params(self.params, new_plan, self.cfg, out=self.sp, slots=self._slots)
        if quantized:  # rebuilt in bf16: new tensors
            self.executor.drop_graphs()
        if self.prefix is not None:
            # the backend rebuilt its pool from the live tables only (shared
            # rows became private copies): the index's references died with
            # the old pool, so drop the entries without a decref
            self.prefix.flush(decref=False)
            self.prefix.pool = self.backend.pool
        self.n_replans += 1
        self.replan_log.append(event)
        if self.obs.enabled:
            # the new plan's promise, from the profile it was planned from
            self.plan_profile = profile
            self._sample_plan_metrics()
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
        with self.obs.trace.span("decode_tick", rows=len(self.active)):
            self.state, logits = self.executor.decode(
                self.sp, self.state, self.pa, self.state.last_tokens,
                active=self.active_mask())
        self.decode_ticks += 1
        toks = self.state.last_tokens.cpu().numpy()
        logits_np = logits.cpu().numpy() if self.scfg.collect_logits else None
        for row in sorted(self.active):
            req = self.active[row]
            self._commit(req, row, int(toks[row]))
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
        lens = self.lengths()
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
        with self.obs.trace.span("decode_tick", rows=len(self.active),
                                 spec_max_depth=int(depth.max())):
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
        g_np, nc = g.cpu().numpy(), n_commit.cpu().numpy()
        # a replay's run stops at the first token that is not the one it
        # produced before its preemption (`_commit` swaps that one in); the
        # entries past it leave the cache, and the trim frees their blocks
        runs, back = {}, {}
        for row in sorted(self.active):
            req, run = self.active[row], [int(t) for t in g_np[row, :int(nc[row])]]
            k = req.n_generated
            cut = next((i for i, t in enumerate(run)
                        if k + i < len(req.replay) and req.replay[k + i] != t), None)
            if cut is not None:
                back[row] = len(run) - cut - 1
                run = run[:cut + 1]
            runs[row] = run
        if any(back.values()):
            st = self.backend.rollback_rows(st, back)
        self.state = self.backend.trim_rows(st, sorted(self.active))
        logits_np = logits.cpu().numpy() if self.scfg.collect_logits else None
        tick_proposed = tick_accepted = 0
        for row in sorted(self.active):
            req = self.active[row]
            n, prop = int(nc[row]), int(depth[row])
            req.spec_proposed += prop
            req.spec_accepted += max(0, n - 1)
            tick_proposed += prop
            tick_accepted += max(0, n - 1)
            # commit the accepted run, cut at EOS / max_new_tokens (the
            # cache may hold a few tokens past the cut; the row retires
            # right below, which frees them with the row)
            for i, tok in enumerate(runs[row]):
                self._commit(req, row, tok)
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
        if self.obs.enabled:
            m = self.obs.metrics
            m.counter("spec_proposed_total",
                      help="draft tokens proposed by speculative decode"
                      ).inc(tick_proposed)
            m.counter("spec_accepted_total",
                      help="draft tokens accepted by the verify pass"
                      ).inc(tick_accepted)
            m.gauge("spec_depth",
                    help="mean adaptive speculation depth over live rows"
                    ).set(float(np.mean([self._spec_depth[r] for r in self.active])))
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
            # prefix lookup before the admission check: a hit discounts the
            # shared blocks from the request's charge
            entry = self._stamp_prefix_hit(req)
            if not self.admissible(req):
                if self.active or self.prefilling:
                    break  # live rows will free blocks as they retire
                entry = self._reclaim_for(req, entry)
                if not self.admissible(req):
                    break
            del self.queue[i]
            if self._should_chunk(req):
                with self.obs.trace.span("admit_chunked", req=req.req_id):
                    row = self._start_chunked(req, entry)
                events["admitted"].append((req.req_id, row))
                continue
            with self.obs.trace.span("admit", req=req.req_id):
                row = self._admit(req)
            if row is None:  # backend memory dry
                self.queue.appendleft(req)
                break
            events["admitted"].append((req.req_id, row))
            if req.is_finished:  # max_new_tokens == 1 or instant EOS
                events["finished"].append(req.req_id)
        # one chunk of every chunked prefill in flight, then one decode tick:
        # a long prompt never blocks the live rows for its whole prefill
        if self.prefilling:
            self._run_chunks(events)
        # one decode tick for every live row: speculative (draft proposals
        # + one multi-query verify) when configured, single-token otherwise
        if self.active and self.spec is not None:
            self._decode_tick_speculative(events)
        elif self.active:
            self._decode_tick(events)
        events["preempted"] = self.n_preemptions - preempted_before
        # one load vector feeds the replan trigger and the gauges
        load = self.per_shard_load()
        imb = self._imbalance_from(load)
        self.trigger.observe(imb)
        if self.obs.enabled:
            self._sample_step_metrics(load, imb)
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
                if not self.active and not self.prefilling:
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
