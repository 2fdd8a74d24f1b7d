"""The port's public API: `EngineConfig` + `Engine` (one-shot and
continuous serving), the stats and observability types, and the planning
building blocks (`build_plan`, `plan_kv_dtypes`, `select_policy`).

The facade loads lazily (PEP 562): the registry decorators must be
importable from the ``compression``/``core`` provider modules without
dragging in the serving stack, which would cycle back into them mid-import.
"""
from __future__ import annotations

import importlib

from repro_torch.api.registry import (  # noqa: F401
    ASSIGNMENT_ENGINE_REGISTRY,
    CACHE_BACKEND_REGISTRY,
    EXECUTOR_REGISTRY,
    POLICY_REGISTRY,
    Registry,
    list_cache_backends,
    list_engines,
    list_executors,
    list_policies,
    register_assignment_engine,
    register_cache_backend,
    register_executor,
    register_policy,
)

_LAZY = {
    "EngineConfig": "repro_torch.api.config",
    "DTYPES": "repro_torch.api.config",
    "Engine": "repro_torch.api.engine",
    "GenerationResult": "repro_torch.api.engine",
    "StreamEvent": "repro_torch.api.engine",
    "PagingConfig": "repro_torch.paging.block_pool",
    "PrefixConfig": "repro_torch.prefix.config",
    "SchedulerConfig": "repro_torch.serving.scheduler",
    "SpeculationConfig": "repro_torch.serving.speculation",
    "Request": "repro_torch.serving.request",
    "synthesize_requests": "repro_torch.serving.request",
    "CompressionConfig": "repro_torch.compression.base",
    "PlannerConfig": "repro_torch.core.planner",
    "ExecutorConfig": "repro_torch.exec.base",
    # planning building blocks
    "PLANNER_MODES": "repro_torch.core.planner",
    "build_plan": "repro_torch.core.planner",
    "plan_kv_dtypes": "repro_torch.core.planner",
    "select_policy": ("repro_torch.compression.policies", "select"),
    # consolidated stats snapshot
    "EngineStats": "repro_torch.api.stats",
    "SchedulerStats": "repro_torch.api.stats",
    "PoolStats": "repro_torch.api.stats",
    "PrefixStats": "repro_torch.api.stats",
    "PlanStats": "repro_torch.api.stats",
    "SpeculationStats": "repro_torch.api.stats",
    # observability
    "Obs": "repro_torch.obs",
    "ObsConfig": "repro_torch.obs",
    "MetricsRegistry": "repro_torch.obs",
    "TraceBuffer": "repro_torch.obs",
    # continuous-batching helpers
    "latency_percentiles": "repro_torch.serving.request",
}


def __getattr__(name):
    if name in _LAZY:
        target = _LAZY[name]
        module, attr = target if isinstance(target, tuple) else (target, name)
        return getattr(importlib.import_module(module), attr)
    raise AttributeError(f"module 'repro_torch.api' has no attribute {name!r}")


def __dir__():
    return sorted(list(globals()) + list(_LAZY))
