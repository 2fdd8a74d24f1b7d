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
``pod`` into its data axis, as the rules' ``batch = ("pod", "data")`` does;
the ``data`` axis alone (``fsdp`` under ``train_rules``) is the rank's
pod's share of it (`Mesh.fsdp_group`).

The train cells' step (`repro_torch.launch.specs.train_step`) reads its
splits from `train_shards` (a `TrainShards`): the rows over the folded data
axis, the residual stream's positions (``seq_act``), ``ff``, ``vocab``, the
experts and the SSD branch's dims over ``model``, the weights' ``fsdp`` dim
over ``data``.  A split of one
rank is no split there: a group of one issues no collective, so one rank
runs the local step's expressions.  Which groups a parameter's gradient is
summed over comes from its spec (`replicated_over`).
"""
from __future__ import annotations

import contextlib
import threading
from dataclasses import dataclass, field, replace
from typing import Any, Dict, List, Optional, Tuple, Union

import torch

from repro_torch.distributed import comm
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
    ``phys`` name: ``model``; ``("pod", "data")``, the data axis the port's
    mesh folds pods into; ``data``, the rank's pod's share of it (the whole
    data axis on a mesh of one pod); ``pod``."""
    names = (phys,) if isinstance(phys, str) else tuple(phys)
    if names == ("model",):
        return mesh.model_group
    if names == ("pod", "data"):
        return mesh.data_group
    if names == ("data",):
        return mesh.fsdp_group
    if names == ("pod",) and mesh.pod_group is not None:
        return mesh.pod_group
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
    seq: Split = Split()  # the sequence: whole in a serve step

    def gather(self, x: torch.Tensor, s: Split, dim: int) -> torch.Tensor:
        """The rank's shard ``x`` along ``dim`` gathered whole over ``s``'s
        group (``x`` when ``s`` is whole)."""
        return x if s.group is None else comm.all_gather(x, s.group, dim=dim)

    def psum(self, x: torch.Tensor, s: Split) -> torch.Tensor:
        """``x`` summed over ``s``'s group (``x`` when ``s`` is whole)."""
        return x if s.group is None else comm.all_reduce_sum(x, s.group)

    def sum_partial(self, x: torch.Tensor, s: Split) -> torch.Tensor:
        """A product's partial sum over the rank's share of ``s``'s dim (an
        o-projection, ``out_proj``, the experts), summed over its group."""
        return self.psum(x, s)

    def weight(self, w, dim: int):
        """``w`` (a tensor or `QTensor` shard) whole along its d_model dim
        ``dim``: under ``weights_2d`` its ``fsdp_w`` shards all-gathered
        over ``data``, for the one product about to read it."""
        if self.fsdp_w.group is None:
            return w
        return _gather_weight(w, self.fsdp_w.group, dim)

    def sum_ff(self, out: torch.Tensor) -> torch.Tensor:
        """The MLP's partial output over the rank's ``ff`` columns, summed
        over the ff group."""
        return self.sum_partial(out, self.ff)

    def sum_vocab(self, rows: torch.Tensor) -> torch.Tensor:
        """The embedding's rows over the rank's vocab shard (zero rows for
        the ids it does not hold), summed over the vocab's group."""
        return self.sum_partial(rows, self.vocab)

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


# ---------------------------------------------------------------------------
# The train cells' splits
# ---------------------------------------------------------------------------


def _many(s: Split) -> Split:
    """``s``, or no split when it spans one rank."""
    return s if s.size > 1 else Split()


@dataclass(frozen=True)
class TrainShards:
    """The splits the train step needs on one rank under ``train_rules``,
    each resolved for its own dim and none of one rank (a group of one is
    no split: the local expressions run and nothing is issued): ``batch``
    (the rows, over the folded data axis), ``seq`` (``seq_act``: the
    residual stream's positions between layers, over ``model``), ``fsdp``
    (every weight's d_model dim, over ``data``), ``ff`` (the MLP's hidden
    dim), ``vocab`` (the embedding's and head's rows) and ``expert`` (the
    MoE experts), over ``model``, and the SSD branch's ``ssm_proj`` /
    ``ssm_conv`` / ``ssm_inner`` / ``ssm_heads`` (`StepShards`'), under
    ``train_rules``.  Attention is sequence-parallel, so ``heads`` never
    splits.  ``mesh`` is the rank's `repro_torch.launch.mesh.Mesh`.  The
    train step's functions take it as their ``shards`` argument.

    Every value a rank computes whole (the gathered sequence, the routing,
    a scan whose heads stay whole, the encoder) is used by each rank for its
    own share only (its positions, columns, rows or experts), so the
    gradients the ranks hold of it are partial sums that the backward of
    the gather, or of `psum`, adds up."""

    mesh: Any
    batch: Split
    seq: Split
    fsdp: Split
    ff: Split
    vocab: Split
    heads: Split = Split()
    expert: Split = Split()
    ssm_proj: Split = Split()
    ssm_conv: Split = Split()
    ssm_inner: Split = Split()
    ssm_heads: Split = Split()

    def weight(self, w: torch.Tensor, dim: int) -> torch.Tensor:
        """``w`` whole along its d_model dim ``dim``: its ``fsdp`` shards
        all-gathered over ``data`` for the one product about to read it
        (the backward reduce-scatters the gradient).  Called inside a
        layer's remat region, so the gathered weight dies with the layer
        and the backward's recompute gathers it again."""
        if self.fsdp.group is None:
            return w
        return comm.all_gather_diff(w, self.fsdp.group, dim)

    def gather_seq(self, x: torch.Tensor) -> torch.Tensor:
        """A (B, T/model, ...) slice of the sequence as the whole (B, T,
        ...) (the backward reduce-scatters the gradient)."""
        return self.gather(x, self.seq, 1)

    def slice_seq(self, x: torch.Tensor) -> torch.Tensor:
        """The rank's slice (B, T/model, ...) of a whole (B, T, ...)."""
        if self.seq.group is None:
            return x
        n = x.shape[1] // self.seq.size
        return x[:, self.seq.offset(n):self.seq.offset(n) + n]

    def gather(self, x: torch.Tensor, s: Split, dim: int) -> torch.Tensor:
        """`StepShards.gather`, differentiable: the backward reduce-scatters
        the ranks' partial gradients of the whole onto the shard."""
        return x if s.group is None else comm.all_gather_diff(x, s.group, dim)

    def psum(self, x: torch.Tensor, s: Split) -> torch.Tensor:
        """`StepShards.psum`, differentiable: each rank uses the sum for its
        own share, so the backward sums the ranks' gradients too."""
        return x if s.group is None else comm.all_reduce_partial(x, s.group)

    def sum_partial(self, x: torch.Tensor, s: Split) -> torch.Tensor:
        """Partial sums over ``s``'s group of the whole (B, T, ...) sequence,
        summed onto the rank's slice of it (or summed whole, where the
        sequence is whole on every rank: the encoder's)."""
        if s.group is None:
            return x
        if self.seq.group is None:
            return comm.all_reduce_partial(x, s.group)
        return comm.reduce_scatter_diff(x, s.group, 1)

    def sum_ff(self, out: torch.Tensor) -> torch.Tensor:
        """The MLP's partial output over the rank's ``ff`` columns,
        reduce-scattered onto its sequence slice (Megatron-SP)."""
        return self.sum_partial(out, self.ff)

    def sum_vocab(self, rows: torch.Tensor) -> torch.Tensor:
        """The embedding's rows over the rank's vocab shard (zero rows for
        the ids it does not hold), reduce-scattered onto its slice."""
        return self.sum_partial(rows, self.vocab)

    def whole_seq(self) -> "TrainShards":
        """These splits for a sequence whole on every rank (the encoder's
        frames): partial sums are all-reduced, not scattered."""
        return replace(self, seq=Split())


def train_shards(rules: ShardingRules, mesh, *, vocab: int, ff: int, d_model: int, seq: int,
                 batch: int, experts: int = 0, ssm=None) -> TrainShards:
    """`TrainShards` of ``mesh``'s rank for a train step whose global dims
    are ``vocab`` (padded rows), ``ff`` (0: no MLP), ``d_model``, ``seq``
    (the positions a row: a VLM's image prefix and text), ``batch`` (the
    rows), ``experts`` (0: no MoE) and the SSD branch's (``ssm``, an
    `SSMConfig`, or None).  Refuses a layout the step does not run, naming
    the dim: rows the data axis does not divide (every rank must hold rows
    of its own), or, with more than one ``model`` rank, a sequence, vocab,
    ff, expert or ``out_proj`` row dim (d_inner) that stays whole there
    (the partial sums onto the sequence slice need them split).
    ``in_proj``'s columns, the conv's channels and the SSD heads may stay
    whole."""
    def need(logical, dim, what):
        if dim <= 0:
            return Split()
        s = _many(split(rules, mesh, logical, dim))
        n = rules.size(rules.rules.get(logical))
        if n > 1 and s.group is None:
            raise ValueError(f"the train step splits {what} ({dim}) over {n} ranks "
                             f"({logical} -> {rules.rules.get(logical)}); {dim} does not divide")
        return s

    def opt(logical, dim):
        return _many(split(rules, mesh, logical, dim)) if dim > 0 else Split()

    extra = {}
    if ssm is not None and ssm.num_heads > 0:
        d_in, gn = ssm.d_inner, 2 * ssm.n_groups * ssm.state_size
        extra = {"ssm_proj": opt("ff", 2 * d_in + gn + ssm.num_heads),
                 "ssm_conv": opt("ff", d_in + gn),
                 "ssm_inner": need("ff", d_in, "the SSD's inner dim"),
                 "ssm_heads": opt("heads", ssm.num_heads)}
    return TrainShards(mesh=mesh, batch=need("batch", batch, "the batch rows"),
                       seq=need("seq_act", seq, "the sequence"),
                       fsdp=_many(split(rules, mesh, "fsdp", d_model)),
                       ff=need("ff", ff, "the MLP's hidden dim"),
                       vocab=need("vocab", vocab, "the vocabulary"),
                       expert=need("expert", experts, "the experts"), **extra)


def replicated_over(spec: Tuple[MeshAxes, ...], mesh) -> List[Any]:
    """The groups of ``mesh`` (of more than one rank) over which a leaf laid
    out by ``spec`` is replicated: ``model`` and ``data`` where no dim of
    the spec splits over them, and ``pod`` always (no parameter splits
    over pods).  A gradient is summed over these groups; the groups the
    spec names sum it through their gathers' backward."""
    named = set()
    for phys in spec:
        if phys is not None:
            named.update((phys,) if isinstance(phys, str) else phys)
    out = []
    for axis, group in (("model", mesh.model_group), ("data", mesh.fsdp_group),
                        ("pod", mesh.pod_group)):
        if axis not in named and group is not None and group.size > 1:
            out.append(group)
    return out
