"""`repro_torch.frontend` — multi-tenant async serving front end (port of
``repro.frontend``).

Layers, bottom-up (each importable without the ones above it):

- `repro_torch.frontend.config`     — `FrontendConfig` / `PriorityClass`
  (dataclasses only; composed into `EngineConfig`);
- `repro_torch.frontend.queues`     — deficit-round-robin tenant fair queuing
  over token-budget quotas;
- `repro_torch.frontend.admission`  — the SLO-aware admit/queue/degrade/reject
  decision table (and the FCFS baseline);
- `repro_torch.frontend.accounting` — per-tenant rolling TTFT/ITL percentiles,
  SLO attainment, goodput counters (through the engine's metrics registry);
- `repro_torch.frontend.core`       — `FrontendScheduler`: the synchronous pump
  gluing the above around one engine `Scheduler`; `run_frontend_trace`
  drives synthetic traces (the fig10 goodput harness);
- `repro_torch.frontend.bridge`     — `EngineLoop`: the single engine thread +
  thread-safe command/event queues;
- `repro_torch.frontend.http`       — `FrontendServer` / `serve_http`: stdlib
  asyncio HTTP/1.1 + SSE ingress.
"""
from __future__ import annotations

from repro_torch.frontend.accounting import TenantAccounting  # noqa: F401
from repro_torch.frontend.admission import (  # noqa: F401
    AdmissionController,
    Decision,
    FCFSController,
    make_admission,
)
from repro_torch.frontend.bridge import EngineLoop  # noqa: F401
from repro_torch.frontend.config import (  # noqa: F401
    DEFAULT_CLASSES,
    FrontendConfig,
    PriorityClass,
)
from repro_torch.frontend.core import (  # noqa: F401
    FrontendScheduler,
    run_frontend_trace,
)
from repro_torch.frontend.http import FrontendServer, serve_http  # noqa: F401
from repro_torch.frontend.queues import (  # noqa: F401
    DeficitRoundRobin,
    SingleQueue,
)

__all__ = [
    "AdmissionController", "DEFAULT_CLASSES", "Decision",
    "DeficitRoundRobin", "EngineLoop", "FCFSController", "FrontendConfig",
    "FrontendScheduler", "FrontendServer", "PriorityClass", "SingleQueue",
    "TenantAccounting", "make_admission", "run_frontend_trace",
    "serve_http",
]
