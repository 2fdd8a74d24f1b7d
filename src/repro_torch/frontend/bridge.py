"""Engine-loop thread ↔ asyncio bridge (port of ``repro.frontend.bridge``:
the same commands, asks and event shapes).

A scheduler tick blocks its thread until the device has finished (every
step ends in a synchronize), so it cannot yield to an event loop.  The
engine runs in ONE dedicated background thread, the only thread that
touches torch, the device, the scheduler, the cache state or the metrics
registry while the loop runs; the asyncio HTTP layer talks to it through
queues:

- **ingress**: handlers enqueue thread-safe commands (submit / cancel /
  drain / metrics) on the loop's inbox; the engine thread absorbs the
  inbox between pump ticks.  A submission carries its prompt as a numpy
  ``int32`` array, never a tensor;
- **egress**: each submission carries a ``deliver`` callable; the engine
  thread invokes it with per-token event dicts and a terminal ``end``
  event.  An asyncio handler passes
  ``lambda ev: loop.call_soon_threadsafe(aq.put_nowait, ev)`` to land the
  events on its own `asyncio.Queue`; synchronous callers (tests) pass
  ``queue.SimpleQueue().put``.

CUDA graphs: a capture in PyTorch's default (``"global"``) mode breaks if
any other thread makes a CUDA call meanwhile.  `EngineLoop.start` therefore
warms the engine up (`Engine.warmup`: the continuous steps are captured)
in the caller's thread before the loop thread exists, and the loop drives
the engine's own scheduler, whose state those graphs are keyed by, so
serving only replays them.  The loop thread makes the engine's device its
current device before its first tick.

Event shapes (plain dicts, JSON-ready):

- ``{"type": "token", "req_id", "token", "index", "step", "finished"}`` —
  mirrors `repro_torch.api.engine.StreamEvent` field-for-field;
- ``{"type": "end", "req_id", "state", "reason", "tokens",
  "n_generated", "degraded_from"}`` — exactly once per request, after its
  last token event (or immediately, for rejected requests).
"""
from __future__ import annotations

import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional

import numpy as np
import torch

from repro_torch.frontend.config import FrontendConfig
from repro_torch.frontend.core import FrontendScheduler
from repro_torch.serving.request import Request

Deliver = Callable[[dict], None]


@dataclass
class _Watch:
    request: Request
    deliver: Deliver
    emitted: int = 0


@dataclass
class _Submit:
    request: Request
    deliver: Deliver


@dataclass
class _Reply:
    """A synchronous ask serviced by the engine thread between ticks."""

    kind: str  # "metrics" | "summary" | "trace"
    out: "queue.Queue" = field(default_factory=lambda: queue.Queue(1))


class EngineLoop:
    """Background pump thread around one `FrontendScheduler`."""

    def __init__(self, engine, cfg: Optional[FrontendConfig] = None):
        self.engine = engine
        self.cfg = cfg if cfg is not None else getattr(
            engine.cfg, "frontend", None) or FrontendConfig()
        # the scheduler must exist before the thread owns it exclusively
        self.fe = FrontendScheduler(engine._ensure_scheduler(), self.cfg)
        self._inbox: "queue.SimpleQueue" = queue.SimpleQueue()
        self._watch: Dict[int, _Watch] = {}
        self._ids = iter(range(engine._next_req_id, 2 ** 62))
        self._ids_lock = threading.Lock()
        self._stop = threading.Event()
        self._drained = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.error: Optional[BaseException] = None
        self._cuda_index: Optional[int] = None  # set by start()

    # ---- lifecycle ---------------------------------------------------------

    def start(self) -> "EngineLoop":
        """Warm the engine up (its steps captured, in this thread), then
        start the loop thread."""
        if self._thread is not None:
            raise RuntimeError("EngineLoop already started")
        self.engine.warmup()
        dev = self.engine.device  # "cuda" without an index: this thread's card
        self._cuda_index = (None if dev.type != "cuda" else dev.index
                            if dev.index is not None else torch.cuda.current_device())
        self._thread = threading.Thread(target=self._run,
                                        name="repro-engine-loop", daemon=True)
        self._thread.start()
        return self

    def drain(self, timeout: Optional[float] = None) -> bool:
        """Graceful shutdown: stop admitting, decode live rows out.
        Blocks until the frontend is idle (or ``timeout``); the loop thread
        keeps serving metrics asks afterwards until `stop`."""
        self._inbox.put("drain")
        return self._drained.wait(
            timeout if timeout is not None else self.cfg.drain_timeout_s)

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10.0)

    @property
    def draining(self) -> bool:
        return self.fe.draining

    # ---- thread-safe command surface (callable from any thread) ------------

    def submit(self, prompt, *, max_new_tokens: int = 16,
               eos_id: Optional[int] = None, tenant: str = "default",
               priority: int = 1, deadline_s: Optional[float] = None,
               deliver: Deliver) -> Request:
        """Build + enqueue a request; returns it immediately (its req_id is
        final).  All progress arrives through ``deliver``."""
        with self._ids_lock:
            rid = next(self._ids)
        req = Request(req_id=rid, prompt=np.asarray(prompt, np.int32),
                      max_new_tokens=max_new_tokens, eos_id=eos_id,
                      tenant=tenant, priority=priority, deadline_s=deadline_s,
                      arrival_time=time.time())
        self._inbox.put(_Submit(req, deliver))
        return req

    def cancel(self, req_id: int) -> None:
        self._inbox.put(("cancel", req_id))

    def _ask(self, kind: str, timeout: float = 5.0):
        ask = _Reply(kind)
        self._inbox.put(ask)
        try:
            return ask.out.get(timeout=timeout)
        except queue.Empty:
            return None

    def prometheus(self) -> str:
        """Prometheus text, rendered BY the engine thread between ticks (the
        registry is single-writer; rendering off-thread could iterate a
        mutating dict).  Falls back to a direct read once the loop exited."""
        out = self._ask("metrics")
        if out is None:
            out = self.engine.obs.metrics.to_prometheus()
        return out

    def summary(self) -> dict:
        out = self._ask("summary")
        if out is None:
            out = self.fe.summary()
        return out

    # ---- engine thread -----------------------------------------------------

    def _absorb_inbox(self) -> None:
        while True:
            try:
                cmd = self._inbox.get_nowait()
            except queue.Empty:
                return
            if isinstance(cmd, _Submit):
                # watch BEFORE submit: a synchronous rejection (draining /
                # backlog bound) is already terminal and the emission sweep
                # delivers its end event
                self._watch[cmd.request.req_id] = _Watch(cmd.request,
                                                         cmd.deliver)
                self.fe.submit(cmd.request)
            elif isinstance(cmd, _Reply):
                if cmd.kind == "metrics":
                    cmd.out.put(self.engine.obs.metrics.to_prometheus())
                elif cmd.kind == "summary":
                    cmd.out.put(self.fe.summary())
                else:
                    cmd.out.put(None)
            elif cmd == "drain":
                self.fe.drain()
            elif isinstance(cmd, tuple) and cmd[0] == "cancel":
                self.fe.cancel(cmd[1])

    def _emit(self) -> None:
        for rid in list(self._watch):
            w = self._watch[rid]
            req = w.request
            n = req.n_generated
            while w.emitted < n:
                k = w.emitted
                w.emitted = k + 1
                w.deliver({
                    "type": "token", "req_id": rid,
                    "token": int(req.generated[k]), "index": k,
                    "step": self.fe.sched.step_idx,
                    "finished": bool(req.is_finished and k == n - 1)})
            if req.is_finished:
                w.deliver({
                    "type": "end", "req_id": rid, "state": req.state.value,
                    "reason": self.fe.reject_reasons.get(rid, ""),
                    "tokens": [int(t) for t in req.generated],
                    "n_generated": n,
                    "degraded_from": req.degraded_from})
                del self._watch[rid]

    def _run(self) -> None:
        try:
            if self._cuda_index is not None:
                torch.cuda.set_device(self._cuda_index)
            while not self._stop.is_set():
                self._absorb_inbox()
                # emit BEFORE the idle gate: a request made terminal during
                # absorption itself (synchronous rejection while draining /
                # over backlog, cancel of a still-queued request) must
                # deliver its end event even when no pump tick follows —
                # otherwise the awaiting handler hangs forever
                self._emit()
                if self.fe.idle:
                    if self.fe.draining:
                        self._drained.set()
                    time.sleep(self.cfg.idle_sleep_s)
                    continue
                self.fe.pump()
                self._emit()
        except BaseException as e:  # deliver the failure, don't hang clients
            self.error = e
            for rid, w in list(self._watch.items()):
                w.deliver({"type": "end", "req_id": rid, "state": "error",
                           "reason": f"{type(e).__name__}: {e}",
                           "tokens": [], "n_generated": 0,
                           "degraded_from": None})
            self._watch.clear()
            self._drained.set()
            raise
