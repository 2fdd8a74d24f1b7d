"""`LocalExecutor`: one device; CUDA graphs on the card, eager on the CPU.

On a CUDA device (``graphs=True``, the default there) each StepFn is
captured as a CUDA graph once per shape and replayed after:

- ``decode`` per (batch rows, cache backend and geometry);
- ``propose`` per (draft_layers, max_k, batch rows, cache);
- ``verify`` per (draft_layers, window width Q, batch rows, cache);
- ``prefill_chunk`` per (chunk width, sub-state geometry, with or without
  ``head_importance``).

``prefill`` stays eager: a prompt's prefill keeps the card busy (an
8 x 2048 batch of minitron-8b keeps an H100 ~99% busy), so a graph would
save nothing, and its shape changes with every prompt length.

The first call of a shape is the eager warm-up, run for real on a side
stream (it also makes each kernel library's first-launch setup happen
outside a capture); the capture follows and records without running.
A graph reads and writes fixed storage: the slot weights, plan arrays and
state it was captured on (cache, last tokens, and the SSD / conv state and
cross K / V of the families that carry them), plus its own input buffers, into which each call
copies its small inputs (active mask, depths, window, chunk tokens,
positions, quota, the ``headkv`` head weights).  So a graph is keyed by the storage of its state as
well as by its shape: each live state (the one-shot state of
`Engine.generate`, the scheduler's) gets a capture of its own, and a
replan, a splice, a retirement or copy-on-write, which write into the live
tensors, re-capture nothing.  The slot weights and plan arrays are updated
in place too: a call that passes other ``sp`` / ``pa`` objects than the
graph was captured on raises.  The chunk step runs on a private sub-state
per shape, which every call copies the job's state into and back out of:
several chunked prefills may be in flight, each with a sub-state of its
own, and one capture serves them all.

Outputs (logits, proposals, verdicts) live in the graph's memory and are
overwritten by its next replay: a caller that keeps one across steps
clones it.  The new tokens land in ``state.last_tokens`` in place, so the
next step reads them where it was captured to.  Kernel launch counters
(``kernels.build.LAUNCHES``) and the collective counter
(``distributed.comm.COUNTS``, the multi-GPU executor's) count a replay's
work: each graph records the launches and collectives of its capture and
adds them per replay.

No fallback: a capture or a replay that fails raises.  ``graphs=False``
runs every step eagerly on any device (the comparison the tests and the
chip script hold the graphs to).
"""
from __future__ import annotations

import dataclasses
from collections import Counter
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.api.registry import register_executor
from repro_torch.distributed import comm
from repro_torch.exec.base import STEP_KINDS, Executor
from repro_torch.kernels import build
from repro_torch.serving import engine as _serve


@dataclass
class _StepGraph:
    graph: "torch.cuda.CUDAGraph"
    inputs: Dict[str, torch.Tensor]  # the call's small inputs, copied per replay
    state: List[torch.Tensor]  # the state's tensors, kept alive with the graph
    sp: dict  # the slot weights and plan arrays it reads, updated in place
    pa: object
    outputs: Tuple[torch.Tensor, ...]
    launches: Dict[str, int]  # kernel launches per replay
    collectives: object  # a `comm.COUNTS` delta per replay


def _tensors(obj) -> List[torch.Tensor]:
    """The tensors of a (nested) dict / list / dataclass, in a fixed order."""
    if torch.is_tensor(obj):
        return [obj]
    if isinstance(obj, dict):
        return [t for v in obj.values() for t in _tensors(v)]
    if isinstance(obj, (list, tuple)):
        return [t for v in obj for t in _tensors(v)]
    if dataclasses.is_dataclass(obj):
        return [t for f in dataclasses.fields(obj) for t in _tensors(getattr(obj, f.name))]
    return []


def _clone(obj):
    """A copy of a dataclass of tensors in storage of its own."""
    return dataclasses.replace(obj, **{
        f.name: getattr(obj, f.name).clone()
        for f in dataclasses.fields(obj) if torch.is_tensor(getattr(obj, f.name))})


def _clone_state(state):
    """A copy of a ServeState (its cache too) in storage of its own."""
    out = _clone(state)
    if state.cache is not None:
        out.cache = _clone(state.cache)
    return out


@register_executor("local")
class LocalExecutor(Executor):
    name = "local"
    takes_mesh = False  # the multi-GPU executor reuses this class with one
    capture_error_mode = "global"  # torch.cuda.graph's

    def __init__(self, model_cfg, ccfg, exec_cfg=None, mesh=None, paging=None,
                 device="cuda", obs=None, graphs: Optional[bool] = None):
        if mesh is not None and not self.takes_mesh:
            raise ValueError(
                "the 'local' executor runs on a single device and takes no "
                "mesh: use executor='mesh' to run on one, or drop mesh=")
        super().__init__(model_cfg, ccfg, exec_cfg=exec_cfg, mesh=mesh,
                         paging=paging, device=device, obs=obs)
        if graphs is None:
            graphs = self.device.type == "cuda"
        if graphs and self.device.type != "cuda":
            raise ValueError(f"CUDA graphs need a CUDA device, got {self.device}")
        self.graphs = bool(graphs)
        self._graphs: Dict[tuple, _StepGraph] = {}
        self._chunk_states: Dict[tuple, object] = {}  # private chunk sub-states
        self.replays = {k: 0 for k in STEP_KINDS}
        # steps run per kind (graph replays, captures and eager calls of the
        # captured kinds) and the collectives they issued (a mesh's)
        self.step_calls = {k: 0 for k in STEP_KINDS}
        self.step_collectives = {k: Counter() for k in STEP_KINDS}

    # ---- graph machinery ---------------------------------------------------

    def drop_graphs(self) -> None:
        self._graphs.clear()

    def _run(self, kind: str, key: tuple, fn: Callable, state, sp, pa,
             inputs: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, ...]:
        """Run one step: ``fn(**inputs)`` eagerly, or through the graph of
        ``key`` and the state's storage (captured at the first call).
        ``state`` is written in place; ``sp`` and ``pa`` are read."""
        self.step_calls[kind] += 1
        if not self.graphs:
            before = comm.snapshot()
            out = fn(**inputs)
            self.synchronize()
            self.step_collectives[kind].update(comm.since(before))
            return out
        tensors = _tensors(state)
        full = (kind,) + key + (tuple(t.data_ptr() for t in tensors),)
        g = self._graphs.get(full)
        if g is None:
            before = comm.snapshot()
            out = self._capture(full, fn, tensors, sp, pa, inputs)
            self.step_collectives[kind].update(comm.since(before))
        else:
            if sp is not g.sp or pa is not g.pa:
                raise RuntimeError(
                    f"{kind}: the slot weights or plan arrays are not the objects the "
                    f"step was captured on; a replan must copy into them in place")
            for name, value in inputs.items():
                g.inputs[name].copy_(value)
            g.graph.replay()
            self.replays[kind] += 1
            for name, n in g.launches.items():
                build.LAUNCHES[name] += n
            comm.COUNTS.update(g.collectives)
            self.step_collectives[kind].update(g.collectives)
            out = g.outputs
        self.synchronize()
        return out

    def _capture(self, full, fn, tensors, sp, pa, inputs):
        """Eager warm-up on a side stream (this call's real step), then the
        capture, which records the same kernels without running them."""
        static = {name: v.clone() for name, v in inputs.items()}
        main = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            out = fn(**static)
        main.wait_stream(side)
        before, comm_before = dict(build.LAUNCHES), comm.snapshot()
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(graph, capture_error_mode=self.capture_error_mode):
                captured = fn(**static)
            launches = {name: build.LAUNCHES[name] - before[name] for name in before}
            collectives = comm.since(comm_before)
        finally:
            build.LAUNCHES.update(before)  # a capture launches nothing
            comm.restore(comm_before)
        self._graphs[full] = _StepGraph(graph, static, tensors, sp, pa, captured, launches,
                                        collectives)
        self.step_traces[full[0]] += 1
        return out

    def _host(self, x, dtype) -> torch.Tensor:
        """A step input as a tensor on the device, with the given dtype."""
        if torch.is_tensor(x):
            return x.to(device=self.device, dtype=dtype)
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=self.device)

    def _active(self, active, batch: int) -> torch.Tensor:
        if active is None:
            return torch.ones((batch,), dtype=torch.bool, device=self.device)
        return self._host(active, torch.bool)

    # ---- the multi-GPU executor's hooks: the identity on one device --------

    def _step_pa(self, pa):
        """The plan arrays a step reads (a mesh rank: its slots' views)."""
        return pa

    def _step_kw(self) -> dict:
        """Extra keyword arguments of the serving steps (a mesh rank's)."""
        return {}

    def _rows(self, batch: int):
        """(this process's rows of a ``batch``-row state, their global ids
        for the owner rule, None for arange)."""
        return slice(None), None

    def _gather_rows(self, x: torch.Tensor) -> torch.Tensor:
        """A step output over this process's rows → over every row."""
        return x

    # ---- StepFns -----------------------------------------------------------

    # every public step runs through `_observed` (obs on: timed and traced)

    @torch.inference_mode()
    def prefill(self, sp, batch, pa, rows=None, head_importance=None):
        return self._observed("prefill", self._prefill, sp, batch, pa, rows,
                              head_importance)

    @torch.inference_mode()
    def prefill_chunk(self, sp, tokens, pa, state, rows, start, valid, quota,
                      head_importance=None):
        return self._observed("prefill_chunk", self._prefill_chunk, sp, tokens, pa,
                              state, rows, start, valid, quota, head_importance)

    @torch.inference_mode()
    def decode(self, sp, state, pa, tokens=None, active=None):
        return self._observed("decode", self._decode, sp, state, pa, tokens, active)

    @torch.inference_mode()
    def propose(self, sp, state, pa, depths, active=None, *, draft_layers, max_k):
        return self._observed("propose", self._propose, sp, state, pa, depths, active,
                              draft_layers, max_k)

    @torch.inference_mode()
    def verify(self, sp, state, pa, tokens, q_lens, active=None, *, draft_layers):
        return self._observed("verify", self._verify, sp, state, pa, tokens, q_lens,
                              active, draft_layers)

    def _prefill(self, sp, batch, pa, rows, head_importance):
        if head_importance is not None:
            head_importance = self._host(head_importance, torch.float32)
        out = _serve.prefill(sp, batch, self.cfg, pa, self.ccfg, rows=rows,
                             head_importance=head_importance)
        self.synchronize()
        return out

    def _prefill_chunk(self, sp, tokens, pa, state, rows, start, valid, quota,
                       head_importance):
        lpa, kw = self._step_pa(pa), self._step_kw()
        inputs = {"tokens": self._host(tokens, torch.int64),
                  "rows": self._host(rows, torch.int64),
                  "start": self._host(start, torch.int32),
                  "valid": self._host(valid, torch.int32),
                  "quota": self._host(quota, torch.int32)}
        # the headkv weights are one more input, copied into the graph's
        # buffer per call, so one capture serves every chunk
        if head_importance is not None:
            inputs["head_importance"] = self._host(head_importance, torch.float32)
        key = (tuple(inputs["tokens"].shape), _serve.state_layout(state),
               head_importance is not None)
        # chunk jobs in flight each hold a sub-state: the graph runs on a
        # private one, which every call copies the job's state into and out of
        sub = state
        if self.graphs:
            sub = self._chunk_states.get(key)
            if sub is None:
                sub = self._chunk_states[key] = _clone_state(state)
            else:
                _serve.copy_state_(sub, state)

        def fn(tokens, rows, start, valid, quota, head_importance=None):
            new, logits, lens = _serve.prefill_chunk(sp, tokens, self.cfg, lpa, self.ccfg,
                                                     sub, rows, start, valid, quota,
                                                     head_importance=head_importance, **kw)
            sub.last_tokens.copy_(new.last_tokens)
            return logits, lens

        logits, lens = self._run("prefill_chunk", key, fn, sub, sp, pa, inputs)
        if sub is not state:
            _serve.copy_state_(state, sub)
        return dataclasses.replace(state), logits, lens

    def _decode(self, sp, state, pa, tokens, active):
        if tokens is not None and tokens is not state.last_tokens:
            state.last_tokens.copy_(self._host(tokens, state.last_tokens.dtype))
        r, rows = self._rows(state.last_tokens.shape[0])
        lpa, kw = self._step_pa(pa), self._step_kw()

        def fn(active):
            new, logits = _serve.decode_step(sp, state, self.cfg, lpa, self.ccfg,
                                             tokens=state.last_tokens[r], active=active[r],
                                             kv_kinds=self.kv_kinds, phase=self.phase,
                                             rows=rows, **kw)
            state.last_tokens.copy_(self._gather_rows(new.last_tokens))
            return (self._gather_rows(logits),)

        self.phase.fill_(state.decode_steps)
        inputs = {"active": self._active(active, state.last_tokens.shape[0])}
        (logits,) = self._run("decode", (_serve.state_layout(state),), fn, state, sp, pa, inputs)
        return dataclasses.replace(state, decode_steps=state.decode_steps + 1), logits

    def _propose(self, sp, state, pa, depths, active, draft_layers, max_k):
        r, rows = self._rows(state.last_tokens.shape[0])
        lpa, kw = self._step_pa(pa), self._step_kw()
        view = dataclasses.replace(state, last_tokens=state.last_tokens[r])

        def fn(depths, active):
            _, props = _serve.propose_step(sp, view, self.cfg, lpa, self.ccfg, depths[r],
                                           active=active[r], kv_kinds=self.kv_kinds,
                                           draft_layers=draft_layers, max_k=max_k,
                                           phase=self.phase, rows=rows, **kw)
            return (self._gather_rows(props),)

        self.phase.fill_(state.decode_steps)
        inputs = {"depths": self._host(depths, torch.int64),
                  "active": self._active(active, state.last_tokens.shape[0])}
        key = (draft_layers, max_k, _serve.state_layout(state))
        (props,) = self._run("propose", key, fn, state, sp, pa, inputs)
        return dataclasses.replace(state), props

    def _verify(self, sp, state, pa, tokens, q_lens, active, draft_layers):
        r, rows = self._rows(state.last_tokens.shape[0])
        lpa, kw = self._step_pa(pa), self._step_kw()
        view = dataclasses.replace(state, last_tokens=state.last_tokens[r])

        def fn(tokens, q_lens, active):
            new, g, n_commit, logits = _serve.verify_step(
                sp, view, self.cfg, lpa, self.ccfg, tokens[r], q_lens[r], active=active[r],
                kv_kinds=self.kv_kinds, draft_layers=draft_layers, phase=self.phase,
                rows=rows, **kw)
            state.last_tokens.copy_(self._gather_rows(new.last_tokens))
            return tuple(self._gather_rows(x) for x in (g, n_commit, logits))

        self.phase.fill_(state.decode_steps)
        inputs = {"tokens": self._host(tokens, torch.int64),
                  "q_lens": self._host(q_lens, torch.int32),
                  "active": self._active(active, state.last_tokens.shape[0])}
        key = (draft_layers, inputs["tokens"].shape[1], _serve.state_layout(state))
        g, n_commit, logits = self._run("verify", key, fn, state, sp, pa, inputs)
        return (dataclasses.replace(state, decode_steps=state.decode_steps + 1),
                g, n_commit, logits)
