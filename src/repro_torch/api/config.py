"""`EngineConfig`: one validated config for the serving stack.

The port's counterpart of ``repro.api.config.EngineConfig`` for what the
port runs: ``ModelConfig`` (architecture), ``CompressionConfig`` (per-head
KV budgets), ``PlannerConfig`` (FairKV placement), ``SchedulerConfig``
(continuous batching), the cache backend and its ``PagingConfig``,
``PrefixConfig`` (chunked prefill and shared-prefix reuse),
``SpeculationConfig`` (self-speculative decoding), the executor and its
``ExecutorConfig``, ``ObsConfig`` (metrics and trace), and the
engine-level knobs.  ``__post_init__`` validates every name-typed field
against the port's registries, so a typo fails at construction with the
registered names.  ``device`` defaults to ``"cuda"``: the CPU runs only
when asked for.

`to_dict` / `from_dict` round-trip a config through JSON (the serving
CLI's ``--config`` file).  The dict has the reference's keys for every
field the port has, plus ``device``.  A dict the reference wrote loads
here: of the reference's keys the port lacks, ``compression.append_mode``
and ``paging.decode_impl`` name implementation choices that the port
makes by device (a known value is accepted and dropped), and ``frontend``
is read only by the HTTP front end, which is not ported (ROADMAP A.9,
second part), so it is accepted and dropped too.  Any other unknown key
raises.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field

import torch

from repro_torch.api.registry import (list_cache_backends, list_engines, list_executors,
                                      list_policies)
from repro_torch.compression.base import CompressionConfig
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.configs.base import ModelConfig
from repro_torch.core.planner import PLANNER_MODES, PlannerConfig
from repro_torch.configs.base import MoEConfig, SSMConfig
from repro_torch.exec.base import ExecutorConfig
from repro_torch.obs import ObsConfig
from repro_torch.paging.block_pool import PagingConfig
from repro_torch.prefix.config import PrefixConfig
from repro_torch.serving.engine import _spec_supported
from repro_torch.serving.scheduler import SchedulerConfig
from repro_torch.serving.speculation import SpeculationConfig

# the one dtype-name table: validation and Engine's resolution both read it
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}


@dataclass(frozen=True)
class EngineConfig:
    """Everything `Engine.build` needs, validated at construction.

    ``dtype`` is a string (``float32`` / ``bfloat16`` / ``float16``);
    `Engine` resolves it to a torch dtype.  ``profile_skew`` /
    ``profile_seed`` parameterize the synthetic per-head workload profile
    used when the caller does not supply a measured one.  ``device`` is
    where weights, cache and steps live (``"cuda"``, ``"cuda:1"``,
    ``"cpu"``).  ``cache_backend`` names a registered backend (``"slot"``:
    dense static capacity; ``"paged"``: block pools sized by ``paging``);
    ``scheduler`` configures continuous batching; ``prefix`` turns on
    chunked prefill in it (any backend) and shared-prefix block reuse
    (paged backend only); ``speculation`` turns on self-speculative
    decoding (paged backend only).  ``executor`` names a registered
    executor (``"local"``: one device, its steps captured as CUDA graphs on
    the card and eager on the CPU); ``executor_cfg`` carries its knobs.
    ``obs`` configures the metrics registry and span trace;
    ``ObsConfig(enabled=False)`` swaps every collection point for shared
    no-op objects.
    """

    model: ModelConfig
    compression: CompressionConfig = field(default_factory=CompressionConfig)
    planner: PlannerConfig = field(default_factory=PlannerConfig)
    scheduler: SchedulerConfig = field(default_factory=SchedulerConfig)
    n_shards: int = 1
    dtype: str = "float32"
    max_seq_len: int = 512
    seed: int = 0  # seed of the default parameter init
    profile_skew: float = 1.0
    profile_seed: int = 1
    device: str = "cuda"
    cache_backend: str = "slot"
    paging: PagingConfig = field(default_factory=PagingConfig)
    prefix: PrefixConfig = field(default_factory=PrefixConfig)
    speculation: SpeculationConfig = field(default_factory=SpeculationConfig)
    executor: str = "local"
    executor_cfg: ExecutorConfig = field(default_factory=ExecutorConfig)
    obs: ObsConfig = field(default_factory=ObsConfig)

    def __post_init__(self):
        if not isinstance(self.model, ModelConfig):
            raise TypeError(
                f"model must be a ModelConfig, got {type(self.model).__name__}")
        policy = self.compression.policy
        if policy != "none" and policy not in list_policies():
            raise ValueError(
                f"unknown compression policy {policy!r}; registered: "
                f"{list_policies()} (plus 'none')")
        if self.planner.mode not in PLANNER_MODES:
            raise ValueError(
                f"unknown planner mode {self.planner.mode!r}; known: "
                f"{list(PLANNER_MODES)}")
        if self.planner.engine not in list_engines():
            raise ValueError(
                f"unknown assignment engine {self.planner.engine!r}; "
                f"registered: {list_engines()}")
        if self.dtype not in DTYPES:
            raise ValueError(
                f"unknown dtype {self.dtype!r}; known: {list(DTYPES)}")
        if self.n_shards < 1:
            raise ValueError(f"n_shards must be >= 1, got {self.n_shards}")
        if self.max_seq_len < 1:
            raise ValueError(
                f"max_seq_len must be >= 1, got {self.max_seq_len}")
        if self.compression.budget < 1:
            raise ValueError(
                f"compression.budget must be >= 1, got "
                f"{self.compression.budget}")
        if self.scheduler.max_rows < 1:
            raise ValueError(
                f"scheduler.max_rows must be >= 1, got "
                f"{self.scheduler.max_rows}")
        if self.cache_backend not in list_cache_backends():
            raise ValueError(
                f"unknown cache backend {self.cache_backend!r}; registered: "
                f"{list_cache_backends()}")
        if not isinstance(self.paging, PagingConfig):
            raise TypeError(
                f"paging must be a PagingConfig, got "
                f"{type(self.paging).__name__}")
        # int8/fp8 pools exist only on the paged backend, and overrides must
        # address real (layer, head) cells of this model
        if self.paging.kv_dtype != "fp32":
            if self.cache_backend != "paged":
                raise ValueError(
                    f"paging.kv_dtype={self.paging.kv_dtype!r} (quantized "
                    f"KV pools) requires cache_backend='paged', got "
                    f"{self.cache_backend!r}")
            L, H = self.model.n_layers, self.model.n_kv_heads
            for lyr, hd, dt in self.paging.kv_dtype_overrides:
                if lyr >= L or hd >= H:
                    raise ValueError(
                        f"paging.kv_dtype override ({lyr}, {hd}) -> {dt!r} "
                        f"out of range for model {self.model.name!r} with "
                        f"{L} layers x {H} kv heads")
        if self.executor not in list_executors():
            raise ValueError(
                f"unknown executor {self.executor!r}; registered: "
                f"{list_executors()}; add executors with "
                f"@repro_torch.api.register_executor")
        if not isinstance(self.executor_cfg, ExecutorConfig):
            raise TypeError(
                f"executor_cfg must be an ExecutorConfig, got "
                f"{type(self.executor_cfg).__name__}")
        if not isinstance(self.obs, ObsConfig):
            raise TypeError(
                f"obs must be an ObsConfig, got {type(self.obs).__name__}")
        if not isinstance(self.prefix, PrefixConfig):
            raise TypeError(
                f"prefix must be a PrefixConfig, got {type(self.prefix).__name__}")
        if self.prefix.enabled and self.cache_backend != "paged":
            raise ValueError(
                "prefix.enabled (shared-prefix block reuse) requires "
                f"cache_backend='paged', got {self.cache_backend!r}; "
                "chunked prefill alone (prefix.chunk_tokens > 0, "
                "enabled=False) works on any backend")
        if not isinstance(self.speculation, SpeculationConfig):
            raise TypeError(
                f"speculation must be a SpeculationConfig, got "
                f"{type(self.speculation).__name__}")
        if self.speculation.enabled:
            if self.cache_backend != "paged":
                raise ValueError(
                    "speculation.enabled requires cache_backend='paged' "
                    "(provisional blocks + rollback-on-reject), got "
                    f"{self.cache_backend!r}")
            _spec_supported(self.model)
            if self.speculation.draft_layers > self.model.n_layers:
                raise ValueError(
                    f"speculation.draft_layers={self.speculation.draft_layers} "
                    f"exceeds the model's {self.model.n_layers} layers")
        torch.device(self.device)  # raises on a malformed device string

    # ---- constructors ------------------------------------------------------

    @classmethod
    def for_arch(cls, arch: str, *, smoke: bool = False,
                 **overrides) -> "EngineConfig":
        """Config for a registered architecture id.  ``smoke=True`` uses the
        arch's reduced CPU-testable variant; remaining keyword arguments
        override `EngineConfig` fields."""
        model = get_smoke_config(arch) if smoke else get_config(arch)
        return cls(model=model, **overrides)

    @classmethod
    def smoke(cls, arch: str, **overrides) -> "EngineConfig":
        """Shorthand for ``for_arch(arch, smoke=True, ...)``."""
        return cls.for_arch(arch, smoke=True, **overrides)

    def replace(self, **changes) -> "EngineConfig":
        """`dataclasses.replace` that re-runs validation."""
        return dataclasses.replace(self, **changes)

    # ---- JSON round trip ---------------------------------------------------

    def to_dict(self) -> dict:
        """JSON-serializable nested dict; `from_dict` round-trips it
        (tuples become lists; ``from_dict`` makes them tuples again and
        every sub-config re-validates)."""
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, data: dict) -> "EngineConfig":
        """Rebuild from a `to_dict()` / JSON-file dict (the port's or the
        reference's; see the module docstring for the reference's keys the
        port drops).  Strict: any other unknown key raises ``ValueError``
        naming its path and the valid keys.  Missing keys take the field
        defaults (``model`` is the one required section)."""
        return _config_from_dict(cls, data, "engine")


_CONFIG_TYPES = {c.__name__: c for c in (
    ModelConfig, MoEConfig, SSMConfig, CompressionConfig, PlannerConfig,
    SchedulerConfig, PagingConfig, ExecutorConfig, ObsConfig, PrefixConfig,
    SpeculationConfig)}

# keys of the reference's dict that the port does not model, with the
# values it accepts (None: any) — each is dropped on load
_REFERENCE_ONLY = {
    ("EngineConfig", "frontend"): None,
    ("CompressionConfig", "append_mode"): ("scatter", "onehot"),
    ("PagingConfig", "decode_impl"): ("auto", "pallas", "gather", "jnp"),
}


def _field_default(f):
    if f.default_factory is not dataclasses.MISSING:  # type: ignore[misc]
        return f.default_factory()
    if f.default is not dataclasses.MISSING:
        return f.default
    return None


def _nested_type(f):
    """The dataclass type a dict value of this field rebuilds into."""
    proto = _field_default(f)
    if dataclasses.is_dataclass(proto):
        return type(proto)
    name = f.type if isinstance(f.type, str) else getattr(f.type, "__name__", None)
    return _CONFIG_TYPES.get(name)


def _config_from_dict(dc_cls, data, path):
    if not isinstance(data, dict):
        raise TypeError(
            f"{path}: expected an object/dict for {dc_cls.__name__}, got "
            f"{type(data).__name__}")
    fields = dataclasses.fields(dc_cls)
    names = [f.name for f in fields]
    kwargs = {}
    for key in sorted(set(data) - set(names)):
        accepted = _REFERENCE_ONLY.get((dc_cls.__name__, key), ())
        if accepted is not None and data[key] not in accepted:
            raise ValueError(
                f"unknown key {key!r} (value {data[key]!r}) at {path!r} for "
                f"{dc_cls.__name__}; valid keys: {names}")
    for f in fields:
        if f.name not in data:
            continue
        v = data[f.name]
        sub = _nested_type(f)
        if sub is not None and isinstance(v, dict):
            v = _config_from_dict(sub, v, f"{path}.{f.name}")
        elif isinstance(v, list):
            # JSON has no tuples; the frozen configs' validators expect them
            v = tuple(tuple(e) if isinstance(e, list) else e for e in v)
        kwargs[f.name] = v
    return dc_cls(**kwargs)
