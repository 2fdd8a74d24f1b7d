"""Per-tenant goodput accounting (port of ``repro.frontend.accounting``:
the same families, labels and buckets, in the port's `obs` registry).

*Goodput* is the serving-quality number the front end optimizes: tokens
delivered by requests that met their latency SLO.  A token decoded for a
request whose TTFT already blew its class target is throughput but not
goodput — the SLO-aware controller spends that capacity on still-viable
requests instead, and this module is where the difference becomes
measurable.

Everything lands in the engine's existing `MetricsRegistry` with a
``tenant=`` label, so ``GET /metrics`` exposes it in Prometheus text with
zero new export machinery:

- ``frontend_admission_total{tenant=,action=}`` — admit/queue/degrade/
  reject decision counts;
- ``frontend_ttft_steps{tenant=}`` / ``frontend_ttft_seconds{tenant=}`` /
  ``frontend_itl_seconds{tenant=}`` — latency histograms;
- ``frontend_ttft_p50_steps{tenant=}`` (and p99 / seconds / itl variants)
  — rolling-window percentile gauges over the last ``latency_window``
  finished requests, the live dashboard numbers;
- ``slo_attained_total{tenant=}`` / ``slo_missed_total{tenant=}`` — SLO
  attainment counters (per finished request);
- ``goodput_tokens_total{tenant=}`` vs ``tokens_total{tenant=}`` —
  SLO-attained vs all generated tokens.

Attainment is judged on *scheduler-step* TTFT (deterministic across
hardware); classes may additionally set wall-clock TTFT/ITL targets, and a
request must meet every configured target to count as attained.
"""
from __future__ import annotations

from collections import deque
from typing import Deque, Dict, Optional

import numpy as np

from repro_torch.frontend.config import FrontendConfig
from repro_torch.serving.request import Request

# fixed buckets for step-valued latency histograms (scheduler steps)
STEP_BUCKETS = (1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0, 256.0, 512.0)
# per-token cadence buckets (seconds) — tighter than the default wall-clock
# buckets, ITL on a smoke model is sub-millisecond
ITL_BUCKETS = (0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01,
               0.025, 0.05, 0.1, 0.25, 1.0)


class _Window:
    """Bounded sample window with cheap percentiles."""

    def __init__(self, maxlen: int):
        self._d: Deque[float] = deque(maxlen=maxlen)

    def push(self, v: float) -> None:
        self._d.append(float(v))

    def __len__(self) -> int:
        return len(self._d)

    def percentile(self, q: float) -> Optional[float]:
        if not self._d:
            return None
        return float(np.percentile(list(self._d), q))


class TenantAccounting:
    """Rolling per-tenant latency/SLO/goodput bookkeeping over one engine's
    metrics registry.  All methods are engine-loop-thread only."""

    def __init__(self, cfg: FrontendConfig, metrics):
        self.cfg = cfg
        self.m = metrics
        self._win: Dict[str, Dict[str, _Window]] = {}
        self._seen: set = set()
        # metric families (registry dedupes by name)
        self.admission = metrics.counter(
            "frontend_admission_total",
            "admission decisions by tenant and action")
        self.ttft_steps = metrics.histogram(
            "frontend_ttft_steps", "TTFT in scheduler steps, per tenant",
            buckets=STEP_BUCKETS)
        self.ttft_seconds = metrics.histogram(
            "frontend_ttft_seconds", "TTFT wall clock, per tenant")
        self.itl_seconds = metrics.histogram(
            "frontend_itl_seconds",
            "mean inter-token latency per finished request, per tenant",
            buckets=ITL_BUCKETS)
        self.attained = metrics.counter(
            "slo_attained_total",
            "finished requests that met every configured SLO target")
        self.missed = metrics.counter(
            "slo_missed_total",
            "finished requests that blew at least one SLO target")
        self.goodput_tokens = metrics.counter(
            "goodput_tokens_total",
            "tokens generated by SLO-attained requests")
        self.tokens = metrics.counter(
            "tokens_total", "all generated tokens, per tenant")
        self.queue_depth = metrics.gauge(
            "frontend_queue_depth", "queued (unadmitted) requests per tenant")
        self.quota_deficit = metrics.gauge(
            "frontend_quota_deficit_tokens",
            "banked DRR deficit per tenant")

    # ---- rolling windows ---------------------------------------------------

    def _windows(self, tenant: str) -> Dict[str, _Window]:
        w = self._win.get(tenant)
        if w is None:
            n = self.cfg.latency_window
            w = self._win[tenant] = {
                "ttft_steps": _Window(n), "ttft_s": _Window(n),
                "itl_s": _Window(n)}
        return w

    def _publish_percentiles(self, tenant: str) -> None:
        w = self._windows(tenant)
        for key, unit in (("ttft_steps", "steps"), ("ttft_s", "seconds"),
                          ("itl_s", "itl_seconds")):
            for q in (50, 99):
                v = w[key].percentile(q)
                if v is None:
                    continue
                name = (f"frontend_ttft_p{q}_{unit}" if unit != "itl_seconds"
                        else f"frontend_itl_p{q}_seconds")
                self.m.gauge(name, f"rolling p{q} over the last "
                             f"{self.cfg.latency_window} finished requests"
                             ).set(v, tenant=tenant)

    # ---- event hooks -------------------------------------------------------

    def on_decision(self, tenant: str, action: str) -> None:
        self._touch(tenant)
        self.admission.inc(1, tenant=tenant, action=action)

    def _touch(self, tenant: str) -> None:
        """Pre-register the attainment families at 0 so the Prometheus
        export carries them even for tenants with no misses (or no
        attainments) yet."""
        if tenant in self._seen:
            return
        self._seen.add(tenant)
        for c in (self.attained, self.missed, self.goodput_tokens,
                  self.tokens):
            c.inc(0, tenant=tenant)

    def on_finished(self, req: Request) -> None:
        """Judge one retired request: record latency samples, attainment,
        and goodput.  Cancelled requests count as missed (they delivered no
        attainable experience) but contribute no latency samples."""
        tenant = req.tenant
        self._touch(tenant)
        self.tokens.inc(req.n_generated, tenant=tenant)
        if req.cancelled:
            self.missed.inc(1, tenant=tenant)
            return
        w = self._windows(tenant)
        ts = req.ttft_steps()
        if ts is not None:
            w["ttft_steps"].push(ts)
            self.ttft_steps.observe(ts, tenant=tenant)
        tsec = req.ttft_seconds()
        if tsec is not None:
            w["ttft_s"].push(tsec)
            self.ttft_seconds.observe(tsec, tenant=tenant)
        itl = req.itl_seconds()
        if itl is not None:
            w["itl_s"].push(itl)
            self.itl_seconds.observe(itl, tenant=tenant)
        self._publish_percentiles(tenant)
        if self.attained_for(req):
            self.attained.inc(1, tenant=tenant)
            self.goodput_tokens.inc(req.n_generated, tenant=tenant)
        else:
            self.missed.inc(1, tenant=tenant)

    def attained_for(self, req: Request) -> bool:
        """True when the request met every SLO target its class configures.
        A request with no first token on record cannot have attained."""
        cls = self.cfg.class_for(req.priority)
        ts = req.ttft_steps()
        if ts is None or ts > cls.ttft_slo_steps:
            return False
        if cls.ttft_slo_s is not None:
            tsec = req.ttft_seconds()
            if tsec is None or tsec > cls.ttft_slo_s:
                return False
        if cls.itl_slo_s is not None:
            itl = req.itl_seconds()
            if itl is not None and itl > cls.itl_slo_s:
                return False
        return True

    def on_queue_sample(self, tenant: str, depth: int,
                        deficit: float) -> None:
        self.queue_depth.set(depth, tenant=tenant)
        self.quota_deficit.set(deficit, tenant=tenant)

    # ---- programmatic summary (benchmarks / tests) -------------------------

    def summary(self) -> dict:
        """Per-tenant dict of the headline numbers, derived from the same
        counters the Prometheus export shows."""
        out = {}
        for tenant in sorted(self._win):
            w = self._win[tenant]
            att = self.attained.value(tenant=tenant)
            mis = self.missed.value(tenant=tenant)
            out[tenant] = {
                "attained": att,
                "missed": mis,
                "attainment": att / (att + mis) if att + mis else None,
                "goodput_tokens": self.goodput_tokens.value(tenant=tenant),
                "tokens": self.tokens.value(tenant=tenant),
                "p50_ttft_steps": w["ttft_steps"].percentile(50),
                "p99_ttft_steps": w["ttft_steps"].percentile(99),
                "p50_itl_s": w["itl_s"].percentile(50),
                "p99_itl_s": w["itl_s"].percentile(99),
            }
        return out
