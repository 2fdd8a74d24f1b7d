"""Logical-axis sharding rules (port of ``repro.distributed.sharding``).

A tensor's dims are named by *logical* axes (``"batch"``, ``"kv_slot"``,
``"ff"``, ...); a ``ShardingRules`` maps each logical axis to mesh axes for
one (mesh, step kind).  The reference hands the rules to GSPMD; the port
slices explicitly, so here they only say what a rank holds: the dry run
(`repro_torch.launch.specs`) reads them to size every argument per rank.
The reference's ``constrain`` has no counterpart: no port code asks the
compiler to reshard.

Mesh axes are ``pod``, ``data`` and ``model``.  The port's `Mesh` folds
``pod`` into its data axis, as the rules' ``batch = ("pod", "data")`` does.
"""
from __future__ import annotations

import contextlib
import threading
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple, Union

MeshAxes = Union[None, str, Tuple[str, ...]]


def mesh_axes(mesh) -> Dict[str, int]:
    """Axis sizes by name of a `repro_torch.launch.mesh.Mesh` (its ``axes``)
    or of a plain ``{name: size}`` mapping."""
    return dict(mesh if isinstance(mesh, dict) else mesh.axes)


@dataclass(frozen=True)
class ShardingRules:
    """Logical → physical axis mapping over mesh axes of given sizes."""

    axes: Dict[str, int]
    rules: Dict[str, MeshAxes] = field(default_factory=dict)

    def size(self, phys: MeshAxes) -> int:
        """Ranks a dim mapped to ``phys`` splits over."""
        if phys is None:
            return 1
        n = 1
        for a in (phys,) if isinstance(phys, str) else phys:
            n *= self.axes[a]
        return n


_state = threading.local()


def current_rules() -> Optional[ShardingRules]:
    return getattr(_state, "rules", None)


@contextlib.contextmanager
def use_rules(rules: Optional[ShardingRules]):
    prev = getattr(_state, "rules", None)
    _state.rules = rules
    try:
        yield
    finally:
        _state.rules = prev


def train_rules(mesh) -> ShardingRules:
    """FSDP(data) × TP(model); batch over pod too when present."""
    axes = mesh_axes(mesh)
    batch = ("pod", "data") if "pod" in axes else ("data",)
    return ShardingRules(axes=axes, rules={
        "batch": batch,
        "seq": None,
        "seq_act": "model",  # Megatron-SP: residual stream seq-sharded over TP
        "d_model": None,
        "ff": "model",
        "heads": "model",
        "kv_slot": "model",
        "kv_heads": "model",
        "vocab": "model",
        "expert": "model",
        "fsdp": "data",  # weight shards gathered per layer (ZeRO-3)
        "cache_len": None,
    })


def serve_rules(mesh, long_context: bool = False, weights_2d: bool = False) -> ShardingRules:
    """Decode: batch over data, slots / ff over model.  Long-context (B = 1):
    the data axis shards the retained-KV capacity instead (split-S
    flash-decode).  ``weights_2d``: every weight's d_model-side dim also
    shards over data (2D tensor parallelism)."""
    axes = mesh_axes(mesh)
    batch = ("pod", "data") if "pod" in axes else ("data",)
    return ShardingRules(axes=axes, rules={
        "batch": None if long_context else batch,
        "seq": None,
        "seq_act": None,
        "d_model": None,
        "ff": "model",
        "heads": "model",
        "kv_slot": "model",
        "kv_heads": "model",
        "vocab": "model",
        "expert": "model",
        "fsdp": None,
        "fsdp_w": "data" if weights_2d else None,
        "cache_len": batch if long_context else None,
    })
