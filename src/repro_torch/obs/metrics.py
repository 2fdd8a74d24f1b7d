"""Host-side metrics registry: Counters, Gauges, fixed-bucket Histograms
(port of ``repro.obs.metrics``; its output is the reference's for the same
calls).

The serving stack's load imbalance, cache pressure, and latency all live in
host-side Python between StepFn invocations — so the registry is plain
Python too: no device tensors, nothing inside a captured CUDA graph.  Every
metric is a *family* of labeled series (``shard_load_tokens{shard="2"}``,
``stepfn_wall_s{kind="decode",executor="mesh"}``); label values arrive as
keyword arguments on the observation call itself, so the hot path is one
dict lookup plus one float add.

Three export surfaces, all derived from one deterministic ``snapshot()``:

- ``snapshot()`` — a plain nested dict (sorted names, sorted label sets),
  the programmatic surface (``Engine.metrics()``, tests, benchmarks);
- ``to_prometheus()`` — Prometheus text exposition format (histograms as
  cumulative ``_bucket{le=...}`` / ``_sum`` / ``_count`` series);
- ``to_jsonl()`` — one JSON object per series, for appending to a log.

Disabling (`ObsConfig.enabled=False`) swaps in ``NULL_REGISTRY``, whose
metric handles are shared no-op singletons — the cost of an instrumented
call site is then one attribute load and one no-op call.
"""
from __future__ import annotations

import json
from bisect import bisect_left
from dataclasses import dataclass
from typing import Dict, Iterable, Optional, Tuple

# default buckets for wall-clock latencies (seconds): sub-ms graph replays
# through multi-second capture/prefill events
DEFAULT_LATENCY_BUCKETS: Tuple[float, ...] = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
    0.25, 0.5, 1.0, 2.5, 5.0, 10.0)


@dataclass(frozen=True)
class ObsConfig:
    """Observability knobs (composed into `EngineConfig`).

    ``enabled``: one switch for the whole subsystem — False swaps every
    collection point to shared no-op singletons (near-zero cost).
    ``trace_capacity``: bounded span-ring size; the oldest events fall off,
    so a long-running server's trace export is always the recent window.
    ``print_every``: scheduler steps between one-line stats prints
    (0 disables).
    """

    enabled: bool = True
    trace_capacity: int = 4096
    print_every: int = 0

    def __post_init__(self):
        if self.trace_capacity < 1:
            raise ValueError(
                f"trace_capacity must be >= 1, got {self.trace_capacity}")
        if self.print_every < 0:
            raise ValueError(
                f"print_every must be >= 0, got {self.print_every}")


def _series_key(labels: dict) -> Tuple[Tuple[str, str], ...]:
    """Canonical (sorted, stringified) label identity of one series."""
    if not labels:
        return ()
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


class Metric:
    """One named family of labeled series."""

    kind = "untyped"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._series: Dict[Tuple[Tuple[str, str], ...], object] = {}

    def series(self):
        """Deterministic iteration: label-key-sorted (labels_dict, state)."""
        for key in sorted(self._series):
            yield dict(key), self._series[key]

    def __len__(self) -> int:
        return len(self._series)


class Counter(Metric):
    """Monotone accumulator.  ``inc(0, **labels)`` pre-registers a series
    at 0 so exports show it before the first real event."""

    kind = "counter"

    def inc(self, amount: float = 1.0, **labels) -> None:
        if amount < 0:
            raise ValueError(f"counter {self.name} cannot decrease "
                             f"(inc {amount})")
        key = _series_key(labels)
        self._series[key] = self._series.get(key, 0.0) + amount

    def value(self, **labels) -> float:
        return float(self._series.get(_series_key(labels), 0.0))

    def total(self) -> float:
        """Sum over every labeled series of the family."""
        return float(sum(self._series.values()))


class Gauge(Metric):
    """Last-write-wins sampled value."""

    kind = "gauge"

    def set(self, value: float, **labels) -> None:
        self._series[_series_key(labels)] = float(value)

    def value(self, default: float = 0.0, **labels) -> float:
        return float(self._series.get(_series_key(labels), default))


class Histogram(Metric):
    """Fixed-bucket histogram (upper bounds; +Inf implicit).

    Internally per-bucket (non-cumulative) counts plus sum/count; the
    Prometheus export emits the conventional cumulative ``le`` series.
    """

    kind = "histogram"

    def __init__(self, name: str, help: str = "",
                 buckets: Iterable[float] = DEFAULT_LATENCY_BUCKETS):
        super().__init__(name, help)
        bounds = tuple(float(b) for b in buckets)
        if not bounds or any(b2 <= b1 for b1, b2 in zip(bounds, bounds[1:])):
            raise ValueError(
                f"histogram {name}: buckets must be non-empty and strictly "
                f"increasing, got {bounds}")
        self.buckets = bounds

    def observe(self, value: float, **labels) -> None:
        key = _series_key(labels)
        st = self._series.get(key)
        if st is None:
            st = self._series[key] = {
                "counts": [0] * (len(self.buckets) + 1),
                "sum": 0.0, "count": 0}
        st["counts"][bisect_left(self.buckets, float(value))] += 1
        st["sum"] += float(value)
        st["count"] += 1

    def count(self, **labels) -> int:
        st = self._series.get(_series_key(labels))
        return 0 if st is None else int(st["count"])

    def mean(self, **labels) -> Optional[float]:
        st = self._series.get(_series_key(labels))
        if st is None or st["count"] == 0:
            return None
        return st["sum"] / st["count"]


class MetricsRegistry:
    """Name-keyed metric families; re-requesting a name returns the same
    family (kind mismatch is a bug and raises)."""

    enabled = True

    def __init__(self):
        self._metrics: Dict[str, Metric] = {}

    def _get(self, cls, name: str, help: str, **kw) -> Metric:
        m = self._metrics.get(name)
        if m is None:
            m = self._metrics[name] = cls(name, help, **kw)
        elif not isinstance(m, cls):
            raise TypeError(
                f"metric {name!r} already registered as {m.kind}, "
                f"requested {cls.kind}")
        return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get(Gauge, name, help)

    def histogram(self, name: str, help: str = "",
                  buckets: Optional[Iterable[float]] = None) -> Histogram:
        if buckets is None:
            return self._get(Histogram, name, help)
        return self._get(Histogram, name, help, buckets=tuple(buckets))

    def get(self, name: str) -> Optional[Metric]:
        return self._metrics.get(name)

    def counter_value(self, name: str, **labels) -> float:
        """0.0 when the counter (or series) was never touched — benchmarks
        read outcomes without caring whether the event ever fired."""
        m = self._metrics.get(name)
        return m.value(**labels) if isinstance(m, Counter) else 0.0

    # ---- exports -----------------------------------------------------------

    def snapshot(self) -> dict:
        """Plain nested dict, fully deterministic (sorted names and label
        sets) — equal observation sequences produce equal snapshots."""
        out = {}
        for name in sorted(self._metrics):
            m = self._metrics[name]
            series = []
            for labels, st in m.series():
                if m.kind == "histogram":
                    cum, acc = {}, 0
                    for b, c in zip(m.buckets, st["counts"]):
                        acc += c
                        cum[f"{b:g}"] = acc
                    cum["+Inf"] = st["count"]
                    series.append({"labels": labels, "sum": st["sum"],
                                   "count": st["count"], "buckets": cum})
                else:
                    series.append({"labels": labels, "value": st})
            out[name] = {"kind": m.kind, "help": m.help, "series": series}
        return out

    def to_prometheus(self) -> str:
        """Prometheus text exposition format (version 0.0.4)."""
        lines = []
        for name, fam in self.snapshot().items():
            if fam["help"]:
                lines.append(f"# HELP {name} {_esc_help(fam['help'])}")
            lines.append(f"# TYPE {name} {fam['kind']}")
            for s in fam["series"]:
                if fam["kind"] == "histogram":
                    for le, c in s["buckets"].items():
                        lines.append(
                            f"{name}_bucket"
                            f"{_fmt_labels({**s['labels'], 'le': le})} {c}")
                    lines.append(
                        f"{name}_sum{_fmt_labels(s['labels'])} "
                        f"{_fmt_value(s['sum'])}")
                    lines.append(
                        f"{name}_count{_fmt_labels(s['labels'])} "
                        f"{s['count']}")
                else:
                    lines.append(f"{name}{_fmt_labels(s['labels'])} "
                                 f"{_fmt_value(s['value'])}")
        return "\n".join(lines) + ("\n" if lines else "")

    def to_jsonl(self) -> str:
        """One JSON object per series (kind, name, labels, payload)."""
        lines = []
        for name, fam in self.snapshot().items():
            for s in fam["series"]:
                rec = {"name": name, "kind": fam["kind"], **s}
                lines.append(json.dumps(rec, sort_keys=True))
        return "\n".join(lines) + ("\n" if lines else "")


# ---------------------------------------------------------------------------
# disabled path: shared no-op singletons
# ---------------------------------------------------------------------------


class _NullMetric:
    """Counter/Gauge/Histogram lookalike whose operations do nothing."""

    __slots__ = ()
    name = help = ""
    buckets = DEFAULT_LATENCY_BUCKETS

    def inc(self, amount: float = 1.0, **labels) -> None:
        pass

    def set(self, value: float, **labels) -> None:
        pass

    def observe(self, value: float, **labels) -> None:
        pass

    def value(self, default: float = 0.0, **labels) -> float:
        return 0.0

    def total(self) -> float:
        return 0.0

    def count(self, **labels) -> int:
        return 0

    def mean(self, **labels) -> Optional[float]:
        return None

    def __len__(self) -> int:
        return 0


_NULL_METRIC = _NullMetric()


class NullRegistry:
    """`MetricsRegistry` lookalike for ``ObsConfig.enabled=False``: every
    family request returns one shared no-op handle, exports are empty."""

    enabled = False

    def counter(self, name: str, help: str = "") -> _NullMetric:
        return _NULL_METRIC

    def gauge(self, name: str, help: str = "") -> _NullMetric:
        return _NULL_METRIC

    def histogram(self, name: str, help: str = "",
                  buckets=None) -> _NullMetric:
        return _NULL_METRIC

    def get(self, name: str) -> None:
        return None

    def counter_value(self, name: str, **labels) -> float:
        return 0.0

    def snapshot(self) -> dict:
        return {}

    def to_prometheus(self) -> str:
        return ""

    def to_jsonl(self) -> str:
        return ""


NULL_REGISTRY = NullRegistry()


# ---------------------------------------------------------------------------
# Prometheus formatting helpers
# ---------------------------------------------------------------------------


def _esc_help(text: str) -> str:
    return text.replace("\\", "\\\\").replace("\n", "\\n")


def _esc_label(value: str) -> str:
    return (value.replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _fmt_labels(labels: dict) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{_esc_label(str(v))}"'
                     for k, v in sorted(labels.items()))
    return "{" + inner + "}"


def _fmt_value(v: float) -> str:
    f = float(v)
    return str(int(f)) if f.is_integer() else repr(f)
