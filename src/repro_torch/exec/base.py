"""`Executor`: the device-execution strategy behind the serving stack.

An executor owns *how* the serving steps run (its StepFns: one prefill
step, one chunked-prefill step, one decode step, and the propose / verify
pair of speculative decoding), while *what* they compute lives in
``repro_torch.serving.engine``.  Built-ins register with
``@repro_torch.api.register_executor``: ``"local"`` (one device; CUDA
graphs on the card, eager on the CPU) and ``"mesh"`` (one process per rank
of a (data, model) mesh over ``torch.distributed``: the slot dim shards
over ``model``, batch rows over ``data``, and the decode o-projection's
all-reduce is the step's one collective; `repro_torch.exec.mesh`).

StepFn contract (the reference's no-recompile rule, DESIGN.md §10): a step
reads the slot weights ``sp``, the plan arrays ``pa`` and the state as
arguments, so a replan is new *values* in the same tensors, never a new
step.  On the card a step is captured once per shape as a CUDA graph (the
counterpart of a ``jax.jit`` trace) and replayed after; ``step_traces``
counts the captures per kind of the ``STEP_KINDS`` table, the regression
observable for "replans must not re-capture".  The legacy
``decode_traces`` / ``prefill_traces`` / ``prefill_chunk_traces`` /
``propose_traces`` / ``verify_traces`` attributes are views into it.

The ring-write phase (``ServeState.decode_steps``, a host int) reaches a
step as ``phase``, a device scalar the executor refreshes before each call,
so a captured step reads the live phase.  Every step ends in a device
synchronize, so a caller's host clock around it covers the device work.

Observability: with an enabled ``obs`` handle (`repro_torch.obs.Obs`, set
by the `Engine` or the scheduler) every StepFn call goes through
`_observe_step`, which records the reference's ``stepfn_wall_s{kind,
executor}`` sample and a ``stepfn_<kind>`` trace span around the call and
its synchronize, and counts a capture in ``stepfn_compiles_total`` (the
reference counts a jit trace there): the "replans never re-capture"
invariant as a metric.  With obs off the calls run unwrapped.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from repro_torch.api.registry import get_executor
from repro_torch.compression.base import CompressionConfig
from repro_torch.configs.base import ModelConfig
from repro_torch.obs import NULL_OBS
from repro_torch.paging import kvquant

# the StepFn kind table: every step an executor owns is one of these, and
# everything keyed per kind (capture counters) derives from this tuple
STEP_KINDS = ("prefill", "prefill_chunk", "decode", "propose", "verify")


@dataclass(frozen=True)
class ExecutorConfig:
    """Execution-level knobs (validated by `EngineConfig`).

    ``donate_state``: the step rewrites the cache buffers in place.  The
    port's steps always do (a captured step replays into the storage it
    was captured on), so ``False`` is rejected.  ``data_axis`` /
    ``model_axis``: the mesh axis names a multi-GPU executor binds batch
    rows / the slot dim to.
    """

    donate_state: bool = True
    data_axis: str = "data"
    model_axis: str = "model"

    def __post_init__(self):
        if not self.data_axis or not self.model_axis:
            raise ValueError("data_axis and model_axis must be non-empty")
        if self.data_axis == self.model_axis:
            raise ValueError(
                f"data_axis and model_axis must differ, both are "
                f"{self.data_axis!r}")
        if not self.donate_state:
            raise ValueError(
                "donate_state=False is not supported: the port's steps "
                "update the cache in place (a captured CUDA graph replays "
                "into the storage it was captured on), so no undonated "
                "copy of the state exists to keep")


class Executor:
    """Interface; see the module docstring for the StepFn contract.

    ``paging`` (a `PagingConfig`) resolves the static (L, H) kind grid of
    int8/fp8 pools once; the decode step indexes it by the plan's
    ``slot_head``, so a replan that moves heads between slots needs no new
    grid.  None on unquantized pools.
    """

    name: str = "?"

    def __init__(self, model_cfg: ModelConfig, ccfg: CompressionConfig,
                 exec_cfg: Optional[ExecutorConfig] = None, mesh=None,
                 paging=None, device="cuda", obs=None):
        self.cfg = model_cfg
        self.ccfg = ccfg
        self.exec_cfg = exec_cfg or ExecutorConfig()
        self.mesh = mesh
        self.paging = paging
        self.obs = obs if obs is not None else NULL_OBS
        self.device = torch.device(device)
        spec = kvquant.spec_from_paging(paging)
        self.kv_kinds = (None if spec is None else torch.as_tensor(
            kvquant.kind_grid(spec, model_cfg.n_layers, model_cfg.n_kv_heads),
            device=self.device))
        # the ring-write phase every step reads (refreshed per call)
        self.phase = torch.zeros((), dtype=torch.int64, device=self.device)
        # captures per StepFn kind: one per distinct shape, never per replan
        self.step_traces = {k: 0 for k in STEP_KINDS}

    # legacy per-kind counters: views into the STEP_KINDS table

    @property
    def prefill_traces(self) -> int:
        return self.step_traces["prefill"]

    @property
    def prefill_chunk_traces(self) -> int:
        return self.step_traces["prefill_chunk"]

    @property
    def decode_traces(self) -> int:
        return self.step_traces["decode"]

    @property
    def propose_traces(self) -> int:
        return self.step_traces["propose"]

    @property
    def verify_traces(self) -> int:
        return self.step_traces["verify"]

    # ---- geometry ----------------------------------------------------------

    @property
    def pool_partitions(self) -> int:
        """Model-axis partitions of the paged block pool (1 = one flat
        pool; a multi-GPU executor returns its model size)."""
        return 1

    @property
    def row_partitions(self) -> int:
        """Data-axis partitions of the pool / batch rows (1 = none)."""
        return 1

    def local_slots(self, n_slots: int) -> slice:
        """The slots of an ``n_slots`` grid whose weights and cache this
        process holds: all of them on one device."""
        return slice(0, n_slots)

    def shard_state(self, state):
        """Lay a prefill's ServeState (every row of the batch) out for this
        executor's decode: the identity on one device."""
        return state

    def synchronize(self) -> None:
        """Wait for the device (no-op on the CPU, which runs synchronously)."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def drop_graphs(self) -> None:
        """Forget every captured step (the next call of each captures
        again): for a replan that put new tensors into the slot weights'
        tree (one of int8 weights, rebuilt in bf16).  A no-op without
        graphs."""

    # ---- StepFns -----------------------------------------------------------

    def prefill(self, sp: dict, batch: dict, pa,
                rows: Optional[torch.Tensor] = None,
                head_importance: Optional[torch.Tensor] = None) -> Tuple:
        """Prefill step → (ServeState, logits (B, V), lengths (L, Hkv, B));
        ``rows`` are the global rows the sub-batch will occupy,
        ``head_importance`` ((L, Hkv)) the ``headkv`` policy's weights."""
        raise NotImplementedError

    def prefill_chunk(self, sp: dict, tokens: torch.Tensor, pa, state,
                      rows, start, valid, quota,
                      head_importance: Optional[torch.Tensor] = None) -> Tuple:
        """Chunked-prefill step → (ServeState, logits (B, V), lengths
        (L, Hkv, B)).  ``tokens`` is a fixed-width (B, chunk_tokens) slice
        (the last chunk zero-padded, ``valid`` (B,) counting its real
        tokens), ``start`` (B,) the absolute position of each row's chunk,
        ``quota`` (L,) the per-head keep cap of the boundary compression
        and ``head_importance`` ((L, Hkv), optional) the ``headkv``
        weights: all are step inputs, so one capture serves every chunk of
        every prompt."""
        raise NotImplementedError

    def decode(self, sp: dict, state, pa,
               tokens: Optional[torch.Tensor] = None,
               active: Optional[torch.Tensor] = None) -> Tuple:
        """Decode step → (ServeState, logits (B, V)); ``tokens`` (None: the
        state's last tokens) are fed, ``active`` ((B,) bool) marks the live
        rows (None: all).  The new tokens land in ``state.last_tokens``, in
        place."""
        raise NotImplementedError

    def propose(self, sp: dict, state, pa, depths: torch.Tensor,
                active: Optional[torch.Tensor] = None, *, draft_layers: int,
                max_k: int) -> Tuple:
        """Draft step → (ServeState, proposals (B, max_k)): up to ``depths``
        tokens per row from the first ``draft_layers`` layers (0: all)."""
        raise NotImplementedError

    def verify(self, sp: dict, state, pa, tokens: torch.Tensor,
               q_lens: torch.Tensor, active: Optional[torch.Tensor] = None, *,
               draft_layers: int) -> Tuple:
        """Verify step over (B, Q) window tokens → (ServeState, g (B, Q),
        n_commit (B,), logits (B, Q, V)), rejected entries rolled back."""
        raise NotImplementedError

    # ---- observability ------------------------------------------------------

    def _observed(self, kind: str, fn, *args):
        """``fn(*args)``, through `_observe_step` when obs is on."""
        if not self.obs.enabled:
            return fn(*args)
        return self._observe_step(kind, fn, args)

    def _observe_step(self, kind: str, fn, args) -> Tuple:
        """Run one StepFn call under observation: a ``stepfn_wall_s``
        sample and a ``stepfn_<kind>`` span per call, and a
        ``stepfn_compiles_total`` count plus a ``stepfn_<kind>_compile``
        instant whenever the call captured a CUDA graph (`step_traces`
        grew).  The step ends in its device synchronize, so the sample is
        device completion, not dispatch.  Host-side only: nothing here
        runs inside a capture."""
        if kind not in STEP_KINDS:
            raise ValueError(
                f"unknown StepFn kind {kind!r}; known: {list(STEP_KINDS)}")
        before = self.step_traces[kind]
        t0 = time.perf_counter()
        out = fn(*args)
        dt = time.perf_counter() - t0
        obs = self.obs
        m = obs.metrics
        obs.trace.complete(f"stepfn_{kind}", t0, dt, executor=self.name)
        if self.step_traces[kind] > before:
            m.counter(
                "stepfn_compiles_total",
                help="StepFn (re)traces; decode must stay at one per "
                     "(shape, backend) across replans (DESIGN.md §10)",
            ).inc(kind=kind, executor=self.name)
            obs.trace.instant(f"stepfn_{kind}_compile", executor=self.name)
        m.histogram(
            "stepfn_wall_s",
            help="StepFn wall time per invocation, seconds (blocked on "
                 "device completion)",
        ).observe(dt, kind=kind, executor=self.name)
        return out

    # ---- audit -------------------------------------------------------------

    def decode_collectives(self, sp: dict, state, pa, active=None) -> Tuple:
        """Run one decode step → (state, the collectives it issued as
        ``{group: {kind: {"calls", "elements", "bytes"}}}``) from the
        `repro_torch.distributed.comm` counter (the reference reads its
        compiled HLO instead).  The contract on a mesh: one ``all_reduce``
        over ``model`` per attention layer and no ``all_gather`` over it;
        over ``data`` the step gathers its rows' tokens and logits (only
        when data > 1).  One device issues none.  The step is real: it
        appends to ``state`` like any decode step (``active`` None: every
        row); continue from the returned state."""
        from repro_torch.distributed import comm
        before = comm.snapshot()
        state, _ = self.decode(sp, state, pa, active=active)
        return state, comm.by_kind(comm.since(before))


def make_executor(name: str, model_cfg: ModelConfig, ccfg: CompressionConfig,
                  exec_cfg: Optional[ExecutorConfig] = None, mesh=None,
                  paging=None, device="cuda", obs=None, **kw) -> Executor:
    """Instantiate a registered executor by name; ``kw`` goes to its
    constructor (the local executor's ``graphs``)."""
    return get_executor(name)(model_cfg, ccfg, exec_cfg=exec_cfg, mesh=mesh,
                              paging=paging, device=device, obs=obs, **kw)
