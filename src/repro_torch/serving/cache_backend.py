"""Cache backends: the storage strategy behind the serving engine (port of
``repro.serving.cache_backend``).

A ``CacheBackend`` owns how per-(slot, row) KV is *stored* and *accounted*,
not how it is computed.  Two built-ins:

- ``"slot"``  — the dense slot cache: every (slot, row) padded to the
  static capacity ``C``; no bookkeeping, memory independent of the
  realized compression.
- ``"paged"`` — the block pool (``repro_torch.paging.backend``): blocks
  allocated in proportion to realized lengths; admission is a free-block
  budget and a dry pool preempts instead of corrupting.

The scheduler and the `Engine` call only this interface.  The port's
backends update the ServeState's tensors in place and return the state;
``splice`` / ``prepare_decode`` may raise ``PoolExhausted`` (the
scheduler's preemption signal); ``migrate_cache`` returns the candidate's
lengths and a ``commit`` callback, so a replan can be scored and rejected
without touching the live state.  ``obs`` is the engine's observability
handle (`NULL_OBS` unless the `Engine` or scheduler sets it), into which
``sample_metrics`` records the cache-pressure gauges once per tick.

On a mesh (``mesh``, a `repro_torch.launch.mesh.Mesh`; the multi-GPU
executor's) a backend keeps its host bookkeeping global and identical on
every rank while its device state is the rank's shard: the live state
holds the rank's slots and rows (the last tokens stay global), a
prefill's sub-state the rank's slots and every sub-batch row.  Every host
read of device lengths is `host_lengths`, the same gather on every rank.

An attention-free model (mamba2) has no cache: its state holds only the
recurrent rows, it costs nothing at admission, and its lengths read as
zeros, so its memory and load metrics degrade as the reference's do.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.api.registry import register_cache_backend
from repro_torch.cache.slot_cache import (PlanArrays, SlotCache, copy_fields_, init_cache,
                                          insert_rows, migrate_cache, reset_rows, take_rows)
from repro_torch.compression.base import CompressionConfig
from repro_torch.compression.policies import layer_keep_bound, projected_request_tokens
from repro_torch.configs.base import ModelConfig
from repro_torch.obs import NULL_OBS
from repro_torch.paging.block_pool import PagingConfig, PoolExhausted  # noqa: F401
from repro_torch.serving import engine as _serve
from repro_torch.serving.request import Request


def migrate_slots(cache: SlotCache, old_pa: PlanArrays, new_pa: PlanArrays,
                  mesh=None) -> SlotCache:
    """`migrate_cache` of a live slot cache; on a mesh rank the cache's slot
    dim is all-gathered over the model group first (a replan moves heads
    between ranks), the owner rule runs at the rank's global rows, and the
    rank keeps its slots of the result."""
    if mesh is None:
        return migrate_cache(cache, old_pa, new_pa)
    from repro_torch.distributed import comm
    g = mesh.model_group
    full = SlotCache(k=comm.all_gather(cache.k, g, dim=1), v=comm.all_gather(cache.v, g, dim=1),
                     lengths=comm.all_gather(cache.lengths, g, dim=1),
                     pos=comm.all_gather(cache.pos, g, dim=1), positions=cache.positions)
    n = cache.k.shape[2]
    rows = torch.arange(mesh.data_idx * n, (mesh.data_idx + 1) * n, device=cache.k.device)
    out = migrate_cache(full, old_pa, new_pa, rows=rows)
    sl = mesh.slots(out.k.shape[1])
    return SlotCache(k=out.k[:, sl].contiguous(), v=out.v[:, sl].contiguous(),
                     lengths=out.lengths[:, sl].contiguous(), pos=out.pos[:, sl].contiguous(),
                     positions=out.positions)


class CacheBackend:
    """Interface; see the module docstring.

    ``n_shards`` is the plan's model-shard count, so the slot backend can
    enforce ``max_live_tokens_per_shard`` per shard; ``pool_partitions`` /
    ``row_partitions`` split the paged backend's pool into one partition
    per (model shard, data shard) pair, and ``mesh`` is this rank's place
    on the multi-GPU executor's mesh (None on one device).
    """

    name: str = "?"

    def __init__(self, model_cfg: ModelConfig, ccfg: CompressionConfig,
                 max_live_tokens: Optional[int] = None,
                 paging: Optional[PagingConfig] = None,
                 n_shards: int = 1,
                 max_live_tokens_per_shard: Optional[int] = None,
                 pool_partitions: int = 1,
                 row_partitions: int = 1,
                 mesh=None,
                 obs=None):
        self.cfg = model_cfg
        self.ccfg = ccfg
        self.max_live_tokens = max_live_tokens
        self.paging = paging or PagingConfig()
        self.n_shards = int(n_shards)
        self.max_live_tokens_per_shard = max_live_tokens_per_shard
        self.pool_partitions = int(pool_partitions)
        self.row_partitions = int(row_partitions)
        if mesh is not None and (mesh.model, mesh.data) != (self.pool_partitions,
                                                             self.row_partitions):
            raise ValueError(
                f"partitions ({self.pool_partitions}, {self.row_partitions}) do not "
                f"match the mesh (model={mesh.model}, data={mesh.data})")
        self.mesh = mesh
        self.n_rows: Optional[int] = None  # global batch width of the live state
        self.obs = obs if obs is not None else NULL_OBS

    # ---- the mesh: this rank's shard and the global host view --------------

    def host_lengths(self, state, rows: bool = True) -> np.ndarray:
        """The state's (L, S, B) retained lengths on the host, global: on a
        mesh gathered over the model group (and the data group when
        ``rows``, i.e. for the live state), the same on every rank.  An
        attention-free state has no cache: zeros over its one slot."""
        if state.cache is None:
            pa = getattr(self, "pa", None)
            S = 1 if pa is None else int(pa.slot_head.shape[1])
            return np.zeros((self.cfg.n_layers, S, state.last_tokens.shape[0]), np.int32)
        return self._host(state.cache.lengths, rows=rows)

    def _host(self, lengths: torch.Tensor, rows: bool = True) -> np.ndarray:
        """`host_lengths` of a bare (L, S[/model], B[/data]) lengths tensor."""
        if self.mesh is None:
            return lengths.cpu().numpy()
        return self.mesh.host_lengths(lengths, rows=rows)

    def _shard(self, n_slots: int, n_rows: int) -> Tuple[slice, slice]:
        """(slots, rows) of the grid this process holds."""
        if self.mesh is None:
            return slice(0, n_slots), slice(0, n_rows)
        return self.mesh.slots(n_slots), self.mesh.rows(n_rows)

    def _local_rows(self, rows) -> Tuple[np.ndarray, np.ndarray]:
        """(positions in ``rows`` that this process holds, their row ids in
        its shard of the live state)."""
        rows = np.asarray(rows, np.int64).reshape(-1)
        if self.mesh is None:
            return np.arange(rows.size), rows
        r = self.mesh.rows(self.n_rows)
        sel = np.nonzero((rows >= r.start) & (rows < r.stop))[0]
        return sel, rows[sel] - r.start

    # ---- state lifecycle ---------------------------------------------------

    def init_state(self, pa: PlanArrays, batch: int, dtype):
        """Empty B-row ServeState in this backend's layout, on the plan
        arrays' device."""
        raise NotImplementedError

    def from_prefill(self, state, pa: PlanArrays):
        """Adopt a full-batch prefill result (one-shot mode)."""
        return state

    def splice(self, state, sub, rows):
        """Splice a prefilled slot-layout sub-state into ``rows``."""
        raise NotImplementedError

    def release_rows(self, state, rows):
        """Retire rows: clear their state, reclaim their memory."""
        raise NotImplementedError

    def prepare_decode(self, state, active: Optional[Sequence[int]],
                       n_tokens: int = 1):
        """Host hook before a decode tick: the next append of every active
        row (None = all rows) must have backing storage."""
        return state

    def migrate_cache(self, cache, old_pa: PlanArrays, new_pa: PlanArrays,
                      active_rows: Optional[Sequence[int]] = None
                      ) -> Tuple[object, Callable[[], object]]:
        """Trial a re-layout under ``new_pa``: returns the candidate's
        (L, S, B) lengths (enough to score the replan) and a ``commit``
        callback that writes the migrated cache into ``cache``'s tensors
        and returns it.  Infeasibility raises before scoring, never inside
        ``commit``."""
        raise NotImplementedError

    # ---- admission accounting ----------------------------------------------

    def request_cost(self, req: Request) -> int:
        """Projected cost in backend units (tokens / blocks): an upper
        bound on what the request can ever pin."""
        raise NotImplementedError

    def admissible(self, state, req: Request,
                   pending: Sequence[Request] = ()) -> bool:
        """Do free resources cover the request's projected prefill need?
        ``pending`` are requests accepted but not yet spliced into
        ``state`` (in-flight chunked prefills): their charge counts too, so
        admission never promises the same resources twice."""
        raise NotImplementedError

    def never_fits(self, req: Request) -> Optional[str]:
        """Reason string when the request cannot fit even an empty cache
        (fail at submit instead of blocking the queue), else None."""
        return None

    def memory_stats(self, state) -> dict:
        raise NotImplementedError

    def sample_metrics(self, state) -> None:
        """Per-tick gauge sampling (host-side, between steps): record this
        backend's cache-pressure observables into ``self.obs``.  The
        scheduler calls it once per tick when obs is on; the default
        records nothing."""


@register_cache_backend("slot")
class SlotBackend(CacheBackend):
    """Dense static-capacity slot cache.  Admission budget: the projected
    live-token total from the per-policy keep bounds."""

    name = "slot"

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self.pa: Optional[PlanArrays] = None  # for per-shard projection

    def init_state(self, pa, batch, dtype):
        self.pa = pa
        self.n_rows = int(batch)
        dev = pa.slot_head.device
        cache = None
        if self.mesh is not None:  # this rank's slots and rows
            sl, rl = self._shard(int(pa.slot_head.shape[1]), batch)
            cache = init_cache(self.cfg.n_layers, sl.stop - sl.start, rl.stop - rl.start,
                               self.ccfg.static_capacity(), self.cfg.head_dim,
                               dtype=dtype, device=dev)
        return _serve.init_serve_state(self.cfg, pa, batch, self.ccfg,
                                       dtype=dtype, device=dev, cache=cache)

    def from_prefill(self, state, pa):
        self.pa = pa
        self.n_rows = int(state.last_tokens.shape[0])
        return state

    def splice(self, state, sub, rows):
        if self.mesh is None:
            return _serve.splice_state(state, sub, rows)
        sel, loc = self._local_rows(rows)
        if sel.size:
            insert_rows(state.cache, take_rows(sub.cache, sel), loc)
        return _serve.set_row_state(state, rows, sub)

    def release_rows(self, state, rows):
        if self.mesh is None:
            return _serve.reset_state_rows(state, rows)
        sel, loc = self._local_rows(rows)
        if sel.size:
            reset_rows(state.cache, loc)
        return _serve.set_row_state(state, rows)

    def migrate_cache(self, cache, old_pa, new_pa, active_rows=None):
        migrated = migrate_slots(cache, old_pa, new_pa, self.mesh)
        lengths = torch.from_numpy(self._host(migrated.lengths))

        def commit():
            self.pa = new_pa
            return copy_fields_(cache, migrated)

        return lengths, commit

    def live_tokens(self, state) -> int:
        return int(self.host_lengths(state).sum())

    def per_shard_live(self, state) -> np.ndarray:
        """(n_shards,) realized Σ lengths per model shard."""
        per_slot = self.host_lengths(state).sum(axis=(0, 2))  # (S,)
        return per_slot.reshape(self.n_shards, -1).sum(axis=1)

    def per_shard_cost(self, req) -> np.ndarray:
        """(n_shards,) expected Σ lengths a request adds per model shard:
        each head's projected tokens per layer land on the shards holding
        its replicas, ``1/r`` per replica (the strided row split)."""
        sh = self.pa.slot_head.cpu().numpy()  # (L, S)
        rc = self.pa.replica_count.cpu().numpy()
        L, S = sh.shape
        H, cap = self.cfg.n_kv_heads, self.ccfg.static_capacity()
        row_cap = min(req.prompt_len + req.max_new_tokens, cap)
        cost = np.zeros(self.n_shards)
        for layer in range(L):
            bound = layer_keep_bound(self.ccfg.policy, self.ccfg,
                                     req.prompt_len, H, layer, L) / H
            per_head = min(bound + req.max_new_tokens, row_cap)
            w = np.where(sh[layer] >= 0, per_head / rc[layer], 0.0)  # (S,)
            cost += w.reshape(self.n_shards, -1).sum(axis=1)
        return cost

    def request_cost(self, req):
        if self.cfg.attention_free:
            return 0
        return projected_request_tokens(
            self.ccfg.policy, self.ccfg, req.prompt_len, req.max_new_tokens,
            self.cfg.n_layers, self.cfg.n_kv_heads)

    def admissible(self, state, req, pending=()):
        if self.max_live_tokens is not None:
            reserved = sum(self.request_cost(p) for p in pending)
            if (self.live_tokens(state) + reserved + self.request_cost(req)
                    > self.max_live_tokens):
                return False
        if (self.max_live_tokens_per_shard is not None and self.pa is not None
                and not self.cfg.attention_free):
            # the bottleneck shard gates admission
            load = self.per_shard_live(state) + self.per_shard_cost(req)
            for p in pending:
                load = load + self.per_shard_cost(p)
            if (load > self.max_live_tokens_per_shard).any():
                return False
        return True

    def never_fits(self, req):
        if self.max_live_tokens is not None:
            cost = self.request_cost(req)
            if cost > self.max_live_tokens:
                return (f"projected cost {cost} tokens exceeds "
                        f"max_live_tokens={self.max_live_tokens} even on "
                        f"an empty cache")
        if (self.max_live_tokens_per_shard is not None and self.pa is not None
                and not self.cfg.attention_free):
            worst = self.per_shard_cost(req).max()
            if worst > self.max_live_tokens_per_shard:
                return (f"projected per-shard cost {worst:.0f} tokens "
                        f"exceeds max_live_tokens_per_shard="
                        f"{self.max_live_tokens_per_shard} even on an "
                        f"empty cache")
        return None

    def sample_metrics(self, state) -> None:
        if state.cache is None:
            return
        m = self.obs.metrics
        lens = self.host_lengths(state)
        live = int(lens.sum())
        cap = int(lens.size) * self.ccfg.static_capacity()
        m.gauge("cache_live_tokens",
                help="Σ retained KV tokens across the live cache").set(live)
        m.gauge("cache_utilization",
                help="live tokens / static slot capacity (slot backend "
                     "pressure; the paged analog is pool_free_blocks)"
                ).set(live / max(1, cap))

    def memory_stats(self, state) -> dict:
        c = state.cache
        if c is None:
            return {"backend": self.name, "cache_bytes": 0, "live_tokens": 0}
        lens = self.host_lengths(state)
        (L, S, B), (C, Dh) = lens.shape, c.k.shape[3:]
        live = int(lens.sum())
        return {
            "backend": self.name,
            "cache_bytes": int(2 * L * S * B * C * Dh * c.k.element_size()),
            "live_tokens": live,
            "capacity_tokens": int(L * S * B * C),
            "utilization": live / max(1, L * S * B * C),
        }


def make_cache_backend(name: str, model_cfg: ModelConfig,
                       ccfg: CompressionConfig,
                       max_live_tokens: Optional[int] = None,
                       paging: Optional[PagingConfig] = None,
                       n_shards: int = 1,
                       max_live_tokens_per_shard: Optional[int] = None,
                       pool_partitions: int = 1, row_partitions: int = 1,
                       mesh=None, obs=None) -> CacheBackend:
    """Instantiate a registered backend by name."""
    from repro_torch.api.registry import get_cache_backend
    return get_cache_backend(name)(
        model_cfg, ccfg, max_live_tokens=max_live_tokens, paging=paging,
        n_shards=n_shards, max_live_tokens_per_shard=max_live_tokens_per_shard,
        pool_partitions=pool_partitions, row_partitions=row_partitions, mesh=mesh,
        obs=obs)
