"""The collectives of the multi-GPU executor, counted.

Every collective the port issues goes through `all_reduce_sum` or
`all_gather` here, and each call adds to ``COUNTS`` under its kind
(``"all_reduce"`` / ``"all_gather"``) and the name of its group
(``"model"`` / ``"data"``): calls, elements and bytes of the result.  The
count takes the place of the reference's audit of the compiled decode
step's HLO (``repro.distributed.hlo_stats``): the decode contract, one
all-reduce over ``model`` per attention layer (the o-projection) and no
all-gather, is read from it (`Executor.decode_collectives`).  A CUDA graph
records its collectives at capture and the executor adds them per replay,
as it does the kernel launch counters.

Backends.  NCCL takes the card's tensors, inside a captured graph too.
gloo runs on the host; it takes CPU tensors, and CUDA tensors (several
ranks sharing one card, the only multi-rank layout a one-card machine
allows) for both collectives used here: torch 2.11's gloo (the H100
machine's) ran ``all_reduce`` and ``all_gather`` on CUDA tensors
correctly, copying them through host memory itself, so no call stages
them by hand.  A gloo collective synchronizes the device, so a gloo step
is never captured.
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


def _count(kind: str, group, out: torch.Tensor) -> None:
    COUNTS[(kind, group.name, "calls")] += 1
    COUNTS[(kind, group.name, "elements")] += out.numel()
    COUNTS[(kind, group.name, "bytes")] += out.numel() * out.element_size()


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """Sum ``x`` over ``group`` (a `repro_torch.launch.mesh.Group`), in place;
    returns ``x``.  Every rank ends with the same values."""
    _count("all_reduce", group, x)
    dist.all_reduce(x, group=group.pg)
    return x


def all_gather(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """Concatenate every rank's ``x`` along ``dim`` in group-rank order (all
    ranks pass the same shape); returns a new tensor."""
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(group.size)]
    dist.all_gather(parts, x, group=group.pg)
    out = torch.cat(parts, dim=dim)
    _count("all_gather", group, out)
    return out
