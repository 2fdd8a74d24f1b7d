"""Extensibility registries for the ``repro_torch.api`` facade (the port
keeps its own instances, so nothing collides with ``repro.api``'s).

Decorator-based registries replace what used to be hardcoded tables:

- **compression policies** — previously the ``POLICIES`` dict literal in
  ``compression/policies.py``; now any module can do::

      from repro_torch.api import register_policy

      @register_policy("my_policy")
      def my_policy(scores, cfg, layer_idx, n_layers, **kw): ...

  and ``"my_policy"`` immediately works in ``CompressionConfig.policy``,
  ``EngineConfig`` validation, and ``compression.policies.select``.

- **assignment engines** — previously a string if/elif inside
  ``core/assignment.py``; ``@register_assignment_engine("name")`` adds a
  solver for the makespan problem (Eq. 4) that ``assign_items`` and
  ``PlannerConfig.engine`` can name.

- **cache backends** — ``@register_cache_backend("name")`` on a
  ``CacheBackend`` subclass makes ``EngineConfig.cache_backend`` accept the
  name (built-ins: ``slot``, ``paged``).

- **executors** — ``@register_executor("name")`` on an
  ``exec.base.Executor`` subclass makes ``EngineConfig.executor`` accept
  the name (built-in: ``local``, one device, CUDA graphs on the card).

This module is a dependency *leaf*: it imports nothing from ``repro_torch`` at
module scope, so the registered-to modules (``compression.policies``,
``core.assignment``) can import it without cycling through the heavyweight
``repro_torch.api.engine`` facade.  ``list_policies``/``list_engines`` lazily
import the built-in providers so the listings are never empty.
"""
from __future__ import annotations

from typing import Callable, Dict, Iterator, List, Mapping, Optional


class Registry(Mapping):
    """Name → callable mapping with decorator registration.

    Duplicate names are rejected (``ValueError``); unknown lookups raise a
    ``KeyError`` that lists every registered name, so a typo'd policy/engine
    string fails loudly at the front door instead of as a bare ``KeyError``
    deep inside a decode step.
    """

    def __init__(self, kind: str):
        self.kind = kind
        self._items: Dict[str, Callable] = {}

    # ---- registration ------------------------------------------------------

    def register(self, name: Optional[str] = None) -> Callable:
        """Decorator: ``@registry.register("name")`` or ``@registry.register``
        (uses the function's ``__name__``)."""
        if callable(name):  # bare @register usage
            fn, name = name, None
            return self._add(fn.__name__, fn)

        def deco(fn: Callable) -> Callable:
            return self._add(name or fn.__name__, fn)

        return deco

    def _add(self, name: str, fn: Callable) -> Callable:
        if name in self._items:
            raise ValueError(
                f"{self.kind} {name!r} is already registered "
                f"(registered: {self.names()}); unregister it first or "
                f"pick a different name")
        self._items[name] = fn
        return fn

    def unregister(self, name: str) -> None:
        """Remove a registration (primarily for tests / plugin reload)."""
        if name not in self._items:
            raise KeyError(f"{self.kind} {name!r} is not registered")
        del self._items[name]

    # ---- lookup ------------------------------------------------------------

    def names(self) -> List[str]:
        return sorted(self._items)

    # ---- Mapping protocol --------------------------------------------------
    # ``registry[name]`` raises the descriptive KeyError; ``.get`` keeps the
    # standard Mapping default-returning contract (inherited mixin), so dict
    # idioms on the re-exported ``POLICIES`` object keep working.

    def __getitem__(self, name: str) -> Callable:
        try:
            return self._items[name]
        except KeyError:
            raise KeyError(
                f"unknown {self.kind} {name!r}; registered: {self.names()}"
            ) from None

    def __iter__(self) -> Iterator[str]:
        return iter(self._items)

    def __len__(self) -> int:
        return len(self._items)

    def __repr__(self) -> str:
        return f"Registry({self.kind!r}, {self.names()})"


POLICY_REGISTRY = Registry("compression policy")
ASSIGNMENT_ENGINE_REGISTRY = Registry("assignment engine")
CACHE_BACKEND_REGISTRY = Registry("cache backend")
EXECUTOR_REGISTRY = Registry("executor")

register_policy = POLICY_REGISTRY.register
register_assignment_engine = ASSIGNMENT_ENGINE_REGISTRY.register
register_cache_backend = CACHE_BACKEND_REGISTRY.register
register_executor = EXECUTOR_REGISTRY.register


def _ensure_builtin() -> None:
    """Import the built-in providers so their registrations have run.

    Deferred (function-local) imports: at module-import time the providers
    themselves import this module, and importing them eagerly here would
    cycle.
    """
    import repro_torch.compression.policies  # noqa: F401
    import repro_torch.core.assignment  # noqa: F401
    import repro_torch.exec.local  # noqa: F401
    import repro_torch.exec.mesh  # noqa: F401
    import repro_torch.paging.backend  # noqa: F401
    import repro_torch.serving.cache_backend  # noqa: F401


def list_policies() -> List[str]:
    """Registered compression-policy names (built-ins + plugins)."""
    _ensure_builtin()
    return POLICY_REGISTRY.names()


def list_engines() -> List[str]:
    """Registered assignment-engine names (built-ins + plugins)."""
    _ensure_builtin()
    return ASSIGNMENT_ENGINE_REGISTRY.names()


def get_cache_backend(name: str) -> Callable:
    _ensure_builtin()
    return CACHE_BACKEND_REGISTRY[name]


def list_cache_backends() -> List[str]:
    """Registered cache-backend names (built-ins + plugins)."""
    _ensure_builtin()
    return CACHE_BACKEND_REGISTRY.names()


def get_executor(name: str) -> Callable:
    _ensure_builtin()
    return EXECUTOR_REGISTRY[name]


def list_executors() -> List[str]:
    """Registered executor names (built-ins + plugins)."""
    _ensure_builtin()
    return EXECUTOR_REGISTRY.names()
