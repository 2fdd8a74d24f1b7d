"""Bounded span/event ring exportable as Chrome trace-event JSON (port of
``repro.obs.trace``).

``TraceBuffer`` records *complete* spans (``ph="X"``: name, start, duration)
and *instant* events (``ph="i"``) into a fixed-capacity deque — old events
fall off, so the export is always the most recent window and a long-running
server can leave tracing on.  Timestamps are microseconds relative to buffer
creation (`time.perf_counter` based), which is exactly what the trace-event
format wants; the export loads directly in Perfetto / chrome://tracing.

The ``span`` context manager is the instrumentation primitive::

    with obs.trace.span("decode_step", rows=3):
        ...

and costs two ``perf_counter()`` calls plus one dict append when enabled.
``complete()`` records a span whose timing was measured externally (the
executors time around their per-step device synchronize and report after the fact).
Everything here is host-side: spans wrap StepFn *invocations*, never code
inside a captured graph.
"""
from __future__ import annotations

import json
import time
from collections import deque
from contextlib import contextmanager, nullcontext


class TraceBuffer:
    """Fixed-capacity ring of Chrome trace events."""

    enabled = True

    def __init__(self, capacity: int = 4096):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self._events = deque(maxlen=capacity)
        self._t0 = time.perf_counter()

    def __len__(self) -> int:
        return len(self._events)

    def _ts_us(self, t: float) -> float:
        return (t - self._t0) * 1e6

    # ---- recording ---------------------------------------------------------

    @contextmanager
    def span(self, name: str, **args):
        """Time a block as one complete ("X") event; exceptions still
        record the span (with an ``error`` arg) before propagating."""
        t0 = time.perf_counter()
        try:
            yield
        except BaseException as e:
            self.complete(name, t0, time.perf_counter() - t0,
                          error=type(e).__name__, **args)
            raise
        self.complete(name, t0, time.perf_counter() - t0, **args)

    def complete(self, name: str, t_start: float, dur_s: float,
                 **args) -> None:
        """Record an externally timed span (``t_start`` from
        ``time.perf_counter()``)."""
        ev = {"name": name, "ph": "X", "ts": self._ts_us(t_start),
              "dur": dur_s * 1e6, "pid": 0, "tid": 0}
        if args:
            ev["args"] = args
        self._events.append(ev)

    def instant(self, name: str, **args) -> None:
        """Record a point-in-time event (compiles, replans, preemptions)."""
        ev = {"name": name, "ph": "i", "ts": self._ts_us(time.perf_counter()),
              "s": "t", "pid": 0, "tid": 0}
        if args:
            ev["args"] = args
        self._events.append(ev)

    # ---- export ------------------------------------------------------------

    def to_chrome(self) -> dict:
        """Chrome trace-event JSON object (Perfetto-loadable)."""
        return {"traceEvents": list(self._events),
                "displayTimeUnit": "ms",
                "otherData": {"source": "repro_torch.obs"}}

    def export_json(self) -> str:
        return json.dumps(self.to_chrome())


class NullTrace:
    """`TraceBuffer` lookalike for ``ObsConfig.enabled=False``."""

    enabled = False
    capacity = 0

    def __len__(self) -> int:
        return 0

    def span(self, name: str, **args):
        return nullcontext()

    def complete(self, name: str, t_start: float, dur_s: float,
                 **args) -> None:
        pass

    def instant(self, name: str, **args) -> None:
        pass

    def to_chrome(self) -> dict:
        return {"traceEvents": [], "displayTimeUnit": "ms"}

    def export_json(self) -> str:
        return json.dumps(self.to_chrome())


NULL_TRACE = NullTrace()
