"""`MeshExecutor`: the serving steps on a (data, model) mesh of processes
(port of ``repro.exec.mesh``).

This is the path that makes Fair-Copying physical: the slot dim (the
slot-layout attention weights, the slot cache, and the paged backend's
block tables and pool) shards over ``model``, so each model rank holds
exactly the head replicas the planner placed on its slots; batch rows
shard over ``data``, and the replicas of a head split those rows by the
strided owner rule evaluated at global row ids.  Each (head, row) pair has
one owning slot somewhere on the mesh, so the decode o-projection's
partial contractions sum to the full batch in one all-reduce per layer:
the step's only collective over ``model``.

The reference drives the mesh from one process (``shard_map``); the port
runs one process per rank (`repro_torch.launch.mesh`).  Every rank runs the
same engine, scheduler and planner on the same host data, so the host side
stays replicated as long as every host read of device state is the same
gather on every rank: a step's outputs (tokens, logits, lengths) are
gathered over ``data``, and the backends read lengths through
`Mesh.host_lengths`.

Layouts on a rank (``S`` slots, ``B`` rows globally):

- slot weights and the step's plan arrays: the rank's ``S / model`` slots
  (``first_slot`` stays global); the engine slotifies only those;
- the live state (one-shot after `shard_state`, or the scheduler's): the
  cache's ``(S / model, B / data)`` corner, its pool partition, and the
  global ``(B,)`` last tokens, replicated;
- a prefill's or a chunk job's sub-state: the rank's slots and every row
  of the sub-batch.

Prefill runs in the original head layout from each head's replica-0 slot
weights, all-gathered over ``model`` per layer (the same math as the local
executor, so prefill lengths are bitwise the local ones); the sub-batch is
padded to the data width, split over ``data`` and its results gathered.
The chunk step gathers the cache slices and plan arrays over ``model``.

On NCCL (one rank per card) the decode, propose, verify and chunk steps are
CUDA graphs with their collectives inside, through the local executor's
machinery (graphs keyed by their state's storage).  gloo collectives run on
the host, so on gloo every step is eager and ``graphs=True`` raises.

Constraints, checked: a mesh is required; dense decoder-only models only
(qwen1.5's slot biases shard over ``model`` with the slot weights and
prefill gathers them with the weights; MoE's capacity-bounded dispatch
sizes expert capacity from the global token count, so a data-sharded batch
would drop differently); slot weights unquantized; ``S % model == 0``; the
decode and speculative batch a multiple of ``data``.  The reference's
``_slot_rms_norm`` all-reduce belongs to the hybrid family's
attention-output norm (ROADMAP A.11.4).
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.api.registry import register_executor
from repro_torch.cache.slot_cache import (PlanArrays, SlotCache, copy_fields_, row_index,
                                          take_rows)
from repro_torch.distributed import comm
from repro_torch.exec.local import LocalExecutor
from repro_torch.serving import engine as _serve

_FAMILIES = ("dense",)


def _pad_rows(cache: SlotCache, pad: int) -> SlotCache:
    """Widen a slot cache by ``pad`` rows repeating its last row, so it
    splits over the data group (the reference's ``_pad_state_rows``)."""
    idx = torch.arange(cache.k.shape[2] + pad, device=cache.k.device)
    return take_rows(cache, torch.clamp(idx, max=cache.k.shape[2] - 1))


@register_executor("mesh")
class MeshExecutor(LocalExecutor):
    name = "mesh"
    takes_mesh = True
    # NCCL's watchdog thread polls its events while a graph is captured
    capture_error_mode = "thread_local"

    def __init__(self, model_cfg, ccfg, exec_cfg=None, mesh=None, paging=None,
                 device=None, obs=None, graphs: Optional[bool] = None):
        if mesh is None:
            raise ValueError(
                "executor='mesh' needs a mesh: build one with "
                "repro_torch.launch.mesh.make_host_mesh(model=..., data=...) in "
                "every rank of an initialised process group (spawn or torchrun) "
                "and pass it via Engine.build(..., mesh=...)")
        if model_cfg.family not in _FAMILIES or model_cfg.moe.num_experts:
            raise NotImplementedError(
                f"mesh executor supports dense decoder-only attention models, got "
                f"family {model_cfg.family!r} ({model_cfg.name}); use executor='local' "
                f"(moe needs expert parallelism: capacity-bounded dispatch is "
                f"global-batch dependent)")
        if device is not None and torch.device(device).type != mesh.device.type:
            raise ValueError(f"the mesh runs on {mesh.device}, not on {device}")
        if graphs is None:
            graphs = mesh.backend == "nccl"
        if graphs and mesh.backend != "nccl":
            raise ValueError(
                f"graphs=True needs the nccl backend: {mesh.backend} collectives "
                f"run on the host and cannot be captured in a CUDA graph")
        super().__init__(model_cfg, ccfg, exec_cfg=exec_cfg, mesh=mesh, paging=paging,
                         device=mesh.device, obs=obs, graphs=graphs)
        self._local_pas: Dict[int, tuple] = {}  # id(pa) -> (pa, its slots' views)
        self._row_ids: Dict[int, torch.Tensor] = {}  # batch -> this rank's global rows

    @property
    def pool_partitions(self) -> int:
        return self.mesh.model

    @property
    def row_partitions(self) -> int:
        return self.mesh.data

    def local_slots(self, n_slots: int) -> slice:
        return self.mesh.slots(n_slots)

    # ---- checks ------------------------------------------------------------

    def _check(self, sp, pa) -> None:
        S = int(pa.slot_head.shape[1])
        sl = self.mesh.slots(S)  # raises unless S splits over model
        w = sp["layers"][0]["wq_s"]
        if w.dtype in (torch.int8, torch.uint8):
            raise NotImplementedError("mesh executor does not support quantized slot weights")
        if w.shape[0] != sl.stop - sl.start:
            raise ValueError(
                f"slot weights hold {w.shape[0]} slots; this rank's share of {S} is "
                f"{sl.stop - sl.start} (slotify with slots=executor.local_slots(S))")

    def _check_batch(self, batch: int, what: str) -> None:
        if batch % self.mesh.data:
            raise ValueError(
                f"{what} batch {batch} does not split over data={self.mesh.data}; "
                f"size the batch as a multiple of the data width")

    # ---- the hooks of the local executor's steps ---------------------------

    def _step_pa(self, pa):
        hit = self._local_pas.get(id(pa))
        if hit is None or hit[0] is not pa:
            sl = self.mesh.slots(int(pa.slot_head.shape[1]))
            # views: a replan copies into ``pa`` in place and they follow
            hit = (pa, PlanArrays(slot_head=pa.slot_head[:, sl],
                                  replica_idx=pa.replica_idx[:, sl],
                                  replica_count=pa.replica_count[:, sl],
                                  first_slot=pa.first_slot))
            self._local_pas[id(pa)] = hit
        return hit[1]

    def _step_kw(self) -> dict:
        return {"groups": self.mesh}

    def _rows(self, batch: int):
        r = self.mesh.rows(batch)
        ids = self._row_ids.get(batch)
        if ids is None:
            ids = self._row_ids[batch] = torch.arange(r.start, r.stop, device=self.device)
        return r, ids

    def _gather_rows(self, x: torch.Tensor) -> torch.Tensor:
        if self.mesh.data == 1:
            return x
        return comm.all_gather(x, self.mesh.data_group, dim=0)

    def _gather_cache_rows(self, cache: SlotCache) -> SlotCache:
        if self.mesh.data == 1:
            return cache
        g = self.mesh.data_group
        return SlotCache(k=comm.all_gather(cache.k, g, dim=2),
                         v=comm.all_gather(cache.v, g, dim=2),
                         lengths=comm.all_gather(cache.lengths, g, dim=2),
                         pos=comm.all_gather(cache.pos, g, dim=2),
                         positions=comm.all_gather(cache.positions, g, dim=0))

    def shard_state(self, state):
        """A prefill's state (every row) → this rank's rows of it; the last
        tokens stay global."""
        if self.mesh.data == 1:
            return state
        r = self.mesh.rows(state.last_tokens.shape[0])
        return _serve.ServeState(cache=take_rows(state.cache, r),
                                 last_tokens=state.last_tokens,
                                 decode_steps=state.decode_steps)

    # ---- steps -------------------------------------------------------------

    def _split(self, B: int):
        """(padding, this rank's slice) of a ``B``-row sub-batch padded to
        the data width."""
        pad = (-B) % self.mesh.data
        per = (B + pad) // self.mesh.data
        return pad, slice(self.mesh.data_idx * per, (self.mesh.data_idx + 1) * per)

    def _prefill(self, sp, batch, pa, rows, head_importance):
        self._check(sp, pa)
        if set(batch) != {"tokens"}:
            raise NotImplementedError(
                f"mesh prefill supports token prompts, got batch keys {sorted(batch)}")
        tokens = batch["tokens"]
        B = int(tokens.shape[0])
        rows = (torch.arange(B, device=self.device) if rows is None
                else row_index(rows, self.device))
        if head_importance is not None:
            head_importance = self._host(head_importance, torch.float32)
        # pad the sub-batch to the data width (continuous admission prefills
        # one request at a time); a padded row repeats the last row id and
        # is sliced off before anything reads it
        pad, j = self._split(B)
        if pad:
            tokens = torch.cat([tokens, tokens.new_zeros((pad, tokens.shape[1]))])
            rows = torch.cat([rows, rows[-1:].expand(pad)])
        state, logits, lengths = _serve.prefill(
            sp, {"tokens": tokens[j]}, self.cfg, self._step_pa(pa), self.ccfg,
            rows=rows[j], head_importance=head_importance, groups=self.mesh)
        cache = self._gather_cache_rows(state.cache)
        logits = self._gather_rows(logits)
        lengths = lengths if self.mesh.data == 1 else comm.all_gather(
            lengths, self.mesh.data_group, dim=2)
        if pad:
            cache = take_rows(cache, slice(0, B))
            logits, lengths = logits[:B], lengths[..., :B]
        self.synchronize()
        return (_serve.ServeState(cache=cache, last_tokens=torch.argmax(
            logits[..., :self.cfg.vocab_size], dim=-1), decode_steps=0), logits, lengths)

    def _prefill_chunk(self, sp, tokens, pa, state, rows, start, valid, quota,
                       head_importance):
        self._check(sp, pa)
        if not isinstance(state.cache, SlotCache):
            raise NotImplementedError(
                "mesh chunked prefill accumulates into a slot-layout sub-state "
                "(pagination happens at splice)")
        if self.mesh.data == 1:  # rows are not split: the local executor's step
            return super()._prefill_chunk(sp, tokens, pa, state, rows, start, valid,
                                          quota, head_importance)
        tokens = self._host(tokens, torch.int64)
        rows = self._host(rows, torch.int64)
        start = self._host(start, torch.int32)
        valid = self._host(valid, torch.int32)
        if head_importance is not None:
            head_importance = self._host(head_importance, torch.float32)
        B = int(tokens.shape[0])
        # padded rows repeat the last row with valid=0: they select nothing,
        # and their columns are sliced off
        pad, j = self._split(B)
        sub = state.cache
        if pad:
            tokens = torch.cat([tokens, tokens.new_zeros((pad, tokens.shape[1]))])
            rows = torch.cat([rows, rows[-1:].expand(pad)])
            start = torch.cat([start, start.new_zeros(pad)])
            valid = torch.cat([valid, valid.new_zeros(pad)])
            sub = _pad_rows(sub, pad)
        local = _serve.ServeState(cache=take_rows(sub, j), last_tokens=state.last_tokens,
                                  decode_steps=state.decode_steps)
        new, logits, lens = _serve.prefill_chunk(
            sp, tokens[j], self.cfg, self._step_pa(pa), self.ccfg, local, rows[j],
            start[j], valid[j], self._host(quota, torch.int32),
            head_importance=head_importance, groups=self.mesh)
        cache = self._gather_cache_rows(new.cache)
        logits = self._gather_rows(logits)[:B]
        lens = comm.all_gather(lens, self.mesh.data_group, dim=2)[..., :B]
        copy_fields_(state.cache, take_rows(cache, slice(0, B)) if pad else cache)
        state.last_tokens.copy_(torch.argmax(logits[..., :self.cfg.vocab_size], dim=-1))
        self.synchronize()
        return (_serve.ServeState(cache=state.cache, last_tokens=state.last_tokens,
                                  decode_steps=state.decode_steps), logits, lens)

    def _decode(self, sp, state, pa, tokens, active):
        self._check(sp, pa)
        self._check_batch(int(state.last_tokens.shape[0]), "decode")
        return super()._decode(sp, state, pa, tokens, active)

    def _propose(self, sp, state, pa, depths, active, draft_layers, max_k):
        self._check(sp, pa)
        self._check_batch(int(state.last_tokens.shape[0]), "speculative")
        return super()._propose(sp, state, pa, depths, active, draft_layers, max_k)

    def _verify(self, sp, state, pa, tokens, q_lens, active, draft_layers):
        self._check(sp, pa)
        self._check_batch(int(state.last_tokens.shape[0]), "speculative")
        return super()._verify(sp, state, pa, tokens, q_lens, active, draft_layers)

