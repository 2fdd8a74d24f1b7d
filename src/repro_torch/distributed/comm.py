"""The collectives of the multi-GPU executor and the cell steps, counted.

Every collective the port issues goes through `all_reduce_sum`,
`all_reduce_max`, `all_gather` or `reduce_scatter_sum` here, and each call
adds to ``COUNTS`` under its kind (``"all_reduce"``, ``"all_gather"``,
``"reduce_scatter"``) and the name of its group (``"model"``, ``"data"``,
``"data_in_pod"``, ``"pod"``, ``"world"``): calls, elements and bytes of
the result (a reduce-scatter's is the rank's shard).  The
count takes the place of the reference's audit of the compiled decode
step's HLO (``repro.distributed.hlo_stats``): the decode contract, one
all-reduce over ``model`` per attention layer (the o-projection) and no
all-gather, is read from it (`Executor.decode_collectives`).  A CUDA graph
records its collectives at capture and the executor adds them per replay,
as it does the kernel launch counters.

Backends.  NCCL takes the card's tensors, inside a captured graph too.
gloo runs on the host; it takes CPU tensors, and CUDA tensors (several
ranks sharing one card, the only multi-rank layout a one-card machine
allows) for every collective used here: torch 2.11's gloo (the H100
machine's) ran ``all_reduce`` (sum and max), ``all_gather`` and the list
form of ``reduce_scatter`` on CUDA tensors correctly, fp32 and bf16,
copying them through host memory itself, so no call stages them by
hand.  A gloo collective synchronizes the device, so a gloo step is never
captured.

The train step differentiates through its collectives with four autograd
pairs, each call of either direction counted like any other:
`all_gather_diff` (all-gather forward, reduce-scatter backward: FSDP's
weight gather and the sequence-parallel gather), `reduce_scatter_diff`
(reduce-scatter forward, all-gather backward: the MLP's and the
embedding's partial sums onto the rank's sequence slice),
`all_reduce_grad` (identity forward, all-reduce backward: the gradient of
a leaf replicated over a group), `all_reduce_diff` (all-reduce
forward, identity backward: a sum every rank then uses whole, once, as
the MoE aux loss's router probabilities) and `all_reduce_partial`
(all-reduce both ways: a sum each rank uses for its own share only, as
the SSD gated norm's Σx² over the rank's heads and the encoder's MLP
over its ``ff`` columns, so each holds a partial gradient).
"""
from __future__ import annotations

from collections import Counter
from typing import Dict

import torch
import torch.distributed as dist

# (kind, group name, field) -> total; fields: calls, elements, bytes
COUNTS: Counter = Counter()


def reset_counts() -> None:
    COUNTS.clear()


def snapshot() -> Counter:
    return Counter(COUNTS)


def since(before: Counter) -> Counter:
    """What was counted after ``before`` (a `snapshot`)."""
    return Counter({k: v - before.get(k, 0) for k, v in COUNTS.items()
                    if v != before.get(k, 0)})


def restore(before: Counter) -> None:
    COUNTS.clear()
    COUNTS.update(before)


def by_kind(counts: Counter) -> Dict[str, Dict[str, Dict[str, int]]]:
    """``{group: {kind: {"calls", "elements", "bytes"}}}`` of a count."""
    out: Dict[str, Dict[str, Dict[str, int]]] = {}
    for (kind, group, field), v in counts.items():
        out.setdefault(group, {}).setdefault(
            kind, {"calls": 0, "elements": 0, "bytes": 0})[field] += v
    return out


def _moves(group) -> bool:
    """Whether a collective over ``group`` moves anything: the dry run's
    ``"fake"`` backend moves nothing (its collectives return at once), so
    the call is counted and its output allocated, but not issued."""
    return group.backend != "fake"


def _count(kind: str, group, out: torch.Tensor) -> None:
    COUNTS[(kind, group.name, "calls")] += 1
    COUNTS[(kind, group.name, "elements")] += out.numel()
    COUNTS[(kind, group.name, "bytes")] += out.numel() * out.element_size()


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """Sum ``x`` over ``group`` (a `repro_torch.launch.mesh.Group`), in place;
    returns ``x``.  Every rank ends with the same values."""
    _count("all_reduce", group, x)
    if _moves(group):
        dist.all_reduce(x, group=group.pg)
    return x


def all_reduce_max(x: torch.Tensor, group) -> torch.Tensor:
    """The elementwise max of ``x`` over ``group``, in place; returns ``x``
    (counted as an ``"all_reduce"``)."""
    _count("all_reduce", group, x)
    if _moves(group):
        dist.all_reduce(x, op=dist.ReduceOp.MAX, group=group.pg)
    return x


def all_gather(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """Concatenate every rank's ``x`` along ``dim`` in group-rank order (all
    ranks pass the same shape); returns a new tensor."""
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(group.size)]
    if _moves(group):
        dist.all_gather(parts, x, group=group.pg)
    out = torch.cat(parts, dim=dim)
    _count("all_gather", group, out)
    return out


def reduce_scatter_sum(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The sum of every rank's ``x`` over ``group``, cut along ``dim`` into
    ``group.size`` equal shards; returns the rank's shard (a new tensor).
    Counted by its result, the shard, as the reference's statistics count a
    reduce-scatter (`repro_torch.distributed.step_stats.comm_bytes`)."""
    n = x.shape[dim]
    if n % group.size:
        raise ValueError(f"reduce_scatter_sum: dim {dim} of {n} does not split over "
                         f"{group.size} ranks of {group.name}")
    parts = [p.contiguous() for p in x.movedim(dim, 0).chunk(group.size)]
    out = torch.empty_like(parts[0])
    if _moves(group):
        dist.reduce_scatter(out, parts, group=group.pg)
    out = out.movedim(0, dim)
    _count("reduce_scatter", group, out)
    return out


# ---------------------------------------------------------------------------
# Differentiable pairs (the train step's)
# ---------------------------------------------------------------------------


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter_sum(g, ctx.group, ctx.dim), None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return reduce_scatter_sum(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, ctx.group, ctx.dim), None, None


class _AllReduceGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_sum(g.clone(memory_format=torch.contiguous_format), ctx.group), None


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_sum(x.clone(memory_format=torch.contiguous_format), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _AllReducePartial(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce_sum(x.clone(memory_format=torch.contiguous_format), group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_sum(g.clone(memory_format=torch.contiguous_format), ctx.group), None


def all_gather_diff(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """`all_gather` whose backward reduce-scatters the gradient over the same
    group and dim: each rank's shard gets the sum of every rank's partial
    gradient of the whole."""
    return _AllGather.apply(x, group, dim)


def reduce_scatter_diff(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """`reduce_scatter_sum` whose backward all-gathers the gradient of the
    rank's shard over the same group and dim."""
    return _ReduceScatter.apply(x, group, dim)


def all_reduce_grad(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` unchanged (a view) whose gradient is summed over ``group`` in
    the backward: a tensor replicated over the group whose uses differ per
    rank."""
    return _AllReduceGrad.apply(x, group)


def all_reduce_diff(x: torch.Tensor, group) -> torch.Tensor:
    """`all_reduce_sum` (of a copy: ``x`` is left as it is) whose backward
    passes the gradient through unchanged."""
    return _AllReduce.apply(x, group)


def all_reduce_partial(x: torch.Tensor, group) -> torch.Tensor:
    """`all_reduce_sum` (of a copy) whose backward sums the gradient over
    ``group`` too: the ranks use the sum each for a share of their own, so
    the gradient of a rank's term is the sum of every rank's."""
    return _AllReducePartial.apply(x, group)
