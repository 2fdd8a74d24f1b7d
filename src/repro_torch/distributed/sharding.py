"""Logical-axis sharding rules (port of ``repro.distributed.sharding``).

A tensor's dims are named by *logical* axes (``"batch"``, ``"kv_slot"``,
``"ff"``, ...); a ``ShardingRules`` maps each logical axis to mesh axes for
one (mesh, step kind).  The reference hands the rules to GSPMD; the port
slices explicitly, so here they only say what a rank holds: the dry run
(`repro_torch.launch.specs`) reads them to size every argument per rank.
The reference's ``constrain`` has no counterpart: no port code asks the
compiler to reshard.  A step that runs under the rules on a mesh rank
(the serve cells' step, `repro_torch.launch.specs.serve_step`) reads how
each logical axis splits there from `split` and `step_shards`: the group
it splits over and the rank's offset, so that it hard-codes no axis.

Mesh axes are ``pod``, ``data`` and ``model``.  The port's `Mesh` folds
``pod`` into its data axis, as the rules' ``batch = ("pod", "data")`` does.
"""
from __future__ import annotations

import contextlib
import threading
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple, Union

import torch

from repro_torch.serving.quant import gather as _gather_weight

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

    def guarded(self, dim: int, logical: Optional[str]) -> MeshAxes:
        """``logical``'s mesh axes if ``dim`` divides their extent, else None
        (the dim stays whole)."""
        phys = self.rules.get(logical) if logical is not None else None
        if phys is None or dim % self.size(phys) != 0:
            return None
        return phys


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


# ---------------------------------------------------------------------------
# A rank's splits (explicit SPMD)
# ---------------------------------------------------------------------------


def mesh_group(mesh, phys: MeshAxes):
    """The `repro_torch.launch.mesh.Group` of ``mesh`` that mesh axes
    ``phys`` name: ``model``, or the data axis (``data``, and ``("pod",
    "data")``, which the port's mesh folds into it)."""
    names = (phys,) if isinstance(phys, str) else tuple(phys)
    if names == ("model",):
        return mesh.model_group
    if names in (("data",), ("pod", "data")):
        return mesh.data_group
    raise ValueError(f"no group of the (data, model) mesh spans mesh axes {phys!r}")


@dataclass(frozen=True)
class Split:
    """One logical axis on one rank: the group its dim splits over (None:
    whole on every rank), the rank's index in it and the number of shards."""

    group: Any = None
    index: int = 0
    size: int = 1

    def offset(self, n_local: int) -> int:
        """The global index of the rank's first element along a dim whose
        shard holds ``n_local``."""
        return self.index * n_local


def split(rules: ShardingRules, mesh, logical: Optional[str], dim: int) -> Split:
    """How a dim of extent ``dim`` named ``logical`` splits on ``mesh``'s
    rank under ``rules`` (divisibility-guarded, as the specs are)."""
    phys = rules.guarded(dim, logical)
    if phys is None:
        return Split()
    group = mesh_group(mesh, phys)
    if group.size != rules.size(phys):
        raise ValueError(f"{logical} splits over {rules.size(phys)} ranks under the rules, "
                         f"the mesh's {group.name} group holds {group.size}")
    return Split(group, group.rank, group.size)


@dataclass(frozen=True)
class StepShards:
    """The splits a serve step needs on one rank, resolved for its dims:
    ``vocab`` (the embedding's and head's rows), ``ff`` (the MLP's hidden
    dim), ``fsdp_w`` (every weight's d_model side, under ``weights_2d``),
    ``kv_slot`` (the slot dim), ``batch`` (the rows), ``cache_len`` (the
    cache's columns: split-S decode under ``long_context``, over the batch
    axes), ``expert`` (the MoE experts), the SSD branch's ``ssm_proj``
    (``in_proj``'s columns, 2·d_inner + 2GN + H), ``ssm_conv`` (the conv
    channels, d_inner + 2GN), ``ssm_inner`` (``out_proj``'s rows, d_inner)
    and ``ssm_heads`` (the SSD heads), and ``heads`` / ``kv_heads`` (the
    encoder's and cross attention's query and K / V heads); each is
    resolved for its own dim's extent, so each may split or stay whole on
    its own.  ``mesh`` is the rank's `repro_torch.launch.mesh.Mesh`.  The
    serve step's functions take it as their ``shards`` argument."""

    mesh: Any
    vocab: Split
    ff: Split
    fsdp_w: Split
    kv_slot: Split
    batch: Split
    cache_len: Split = Split()
    expert: Split = Split()
    ssm_proj: Split = Split()
    ssm_conv: Split = Split()
    ssm_inner: Split = Split()
    ssm_heads: Split = Split()
    heads: Split = Split()
    kv_heads: Split = Split()

    def weight(self, w, dim: int):
        """``w`` (a tensor or `QTensor` shard) whole along its d_model dim
        ``dim``: under ``weights_2d`` its ``fsdp_w`` shards all-gathered
        over ``data``, for the one product about to read it."""
        if self.fsdp_w.group is None:
            return w
        return _gather_weight(w, self.fsdp_w.group, dim)

    def rows(self, n_local: int, device) -> Optional[torch.Tensor]:
        """The global ids of the rank's ``n_local`` batch rows (None when the
        rows are whole: the owner rule then counts from 0)."""
        if self.batch.group is None:
            return None
        start = self.batch.offset(n_local)
        return torch.arange(start, start + n_local, device=device)


def step_shards(rules: ShardingRules, mesh, *, vocab: int, ff: int, d_model: int,
                n_slots: int, batch: int, cache_len: int = 0, experts: int = 0,
                ssm=None, heads: int = 0, kv_heads: int = 0) -> StepShards:
    """`StepShards` of ``mesh``'s rank for a step whose global dims are
    ``vocab`` (padded rows), ``ff``, ``d_model``, ``n_slots``, ``batch``,
    ``cache_len`` (the cache's columns), ``experts``, the SSD branch's
    (``ssm``, an `SSMConfig`) and the attention's ``heads`` / ``kv_heads``
    (0 or None: no such dim; a model without slots resolves no slot
    split)."""
    def opt(logical, dim):
        return split(rules, mesh, logical, dim) if dim > 0 else Split()

    extra = {}
    if ssm is not None and ssm.num_heads > 0:
        d_in, gn = ssm.d_inner, 2 * ssm.n_groups * ssm.state_size
        extra = {"ssm_proj": opt("ff", 2 * d_in + gn + ssm.num_heads),
                 "ssm_conv": opt("ff", d_in + gn), "ssm_inner": opt("ff", d_in),
                 "ssm_heads": opt("heads", ssm.num_heads)}
    return StepShards(mesh=mesh, vocab=split(rules, mesh, "vocab", vocab),
                      ff=opt("ff", ff),
                      fsdp_w=split(rules, mesh, "fsdp_w", d_model),
                      kv_slot=opt("kv_slot", n_slots),
                      batch=split(rules, mesh, "batch", batch),
                      cache_len=opt("cache_len", cache_len),
                      expert=opt("expert", experts), heads=opt("heads", heads),
                      kv_heads=opt("kv_heads", kv_heads), **extra)
