"""`repro_torch.obs` — metrics + tracing for the serving stack (the port's
own copy of ``repro.obs``: same metric names, labels, buckets and export
formats, so one dashboard reads both packages).

The subsystem makes the quantities FairKV argues about *observable at
runtime*: per-shard load imbalance (the paper's Figure-2/Eq-4 quantity),
block-pool pressure, StepFn wall time and CUDA-graph captures, and
per-request TTFT/ITL — collected host-side around StepFn boundaries, never
inside a captured graph.

One `Obs` handle bundles the two collectors:

- ``obs.metrics`` — a `MetricsRegistry` of labeled Counters / Gauges /
  Histograms, snapshot-able as a dict and exportable as Prometheus text or
  JSONL (`repro_torch.obs.metrics`);
- ``obs.trace``   — a bounded `TraceBuffer` of timed spans / instant
  events, exportable as Chrome trace-event JSON (`repro_torch.obs.trace`).

`Obs.build(ObsConfig(enabled=False))` (or the shared `NULL_OBS`) swaps both
for no-op singletons, so instrumented call sites cost one attribute load
when observability is off.  The `Engine` facade builds one `Obs` per engine
from ``EngineConfig.obs`` and threads it through the scheduler, executor,
and cache backend; standalone construction of those components defaults to
`NULL_OBS`.
"""
from __future__ import annotations

from repro_torch.obs.metrics import (  # noqa: F401
    DEFAULT_LATENCY_BUCKETS,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    NullRegistry,
    ObsConfig,
    NULL_REGISTRY,
)
from repro_torch.obs.trace import NULL_TRACE, NullTrace, TraceBuffer  # noqa: F401


class Obs:
    """One engine's observability handle: config + metrics + trace."""

    __slots__ = ("cfg", "metrics", "trace")

    def __init__(self, cfg: ObsConfig, metrics, trace):
        self.cfg = cfg
        self.metrics = metrics
        self.trace = trace

    @property
    def enabled(self) -> bool:
        return self.metrics.enabled

    @classmethod
    def build(cls, cfg: "ObsConfig | None" = None) -> "Obs":
        cfg = cfg if cfg is not None else ObsConfig()
        if not cfg.enabled:
            return Obs(cfg, NULL_REGISTRY, NULL_TRACE)
        return cls(cfg, MetricsRegistry(), TraceBuffer(cfg.trace_capacity))


NULL_OBS = Obs(ObsConfig(enabled=False), NULL_REGISTRY, NULL_TRACE)

__all__ = [
    "DEFAULT_LATENCY_BUCKETS", "Counter", "Gauge", "Histogram",
    "MetricsRegistry", "NullRegistry", "NullTrace", "Obs", "ObsConfig",
    "TraceBuffer", "NULL_OBS", "NULL_REGISTRY", "NULL_TRACE",
]
