"""AdamW with fp32 master weights, global-norm clipping, LR schedules (the
port of ``repro.training.optimizer``).

The state keeps {master, mu, nu} in fp32 while the live params stay in
their own dtype (bf16 in production configs), the standard mixed-precision
recipe.  Trees are the model's nested dicts / lists of tensors; the update
runs leaf by leaf, in the reference's order and arithmetic.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, NamedTuple, Tuple

import torch

from repro_torch.distributed import comm


class AdamWState(NamedTuple):
    step: torch.Tensor  # scalar int32
    master: Any  # fp32 copy of params
    mu: Any
    nu: Any


@dataclass(frozen=True)
class OptimizerConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


def tree_leaves(tree: Any) -> List[torch.Tensor]:
    """The tensors of a dict / list tree, dict keys in sorted order (the
    order ``jax.tree.leaves`` gives)."""
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in tree_leaves(v)]
    return [tree]


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` (and the matching leaves of
    ``rest``), keeping the structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree)]
        return type(tree)(*out) if hasattr(tree, "_fields") else type(tree)(out)
    return fn(tree, *rest)


def lr_schedule(cfg: OptimizerConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup → cosine decay to ``min_lr_ratio`` (fp32, as the
    reference)."""
    step = step.float()
    warm = step / max(cfg.warmup_steps, 1)
    frac = (step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1)
    frac = torch.clamp(frac, 0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (1 + torch.cos(math.pi * frac))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)


def init_optimizer(params: Any) -> AdamWState:
    dev = tree_leaves(params)[0].device
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev),
                      master=tree_map(lambda x: x.float().clone(), params),
                      mu=tree_map(lambda x: torch.zeros(x.shape, dtype=torch.float32,
                                                        device=x.device), params),
                      nu=tree_map(lambda x: torch.zeros(x.shape, dtype=torch.float32,
                                                        device=x.device), params))


def global_norm(tree: Any, owner=None) -> torch.Tensor:
    """sqrt of Σ x² over every element of ``tree``.  ``owner``: ``tree``
    holds one rank's shards of a tree laid out over a mesh, and ``owner``
    is (a tree of bools: whether this rank counts each leaf's shard, which
    one replica of every shard does; the group whose ranks hold all the
    shards, `repro_torch.launch.mesh.Group`): the counted leaves' Σ x² is
    summed over the group, so each element of the whole tree counts
    once."""
    sq = [torch.sum(torch.square(x.float())) for x in tree_leaves(tree)]
    if owner is None:
        return torch.sqrt(torch.sum(torch.stack(sq)))
    counts, group = owner
    mine = [s for s, own in zip(sq, tree_leaves(counts)) if own]
    total = torch.sum(torch.stack(mine)) if mine else torch.zeros_like(sq[0])
    return torch.sqrt(comm.all_reduce_sum(total, group))


def adamw_update(grads: Any, state: AdamWState, cfg: OptimizerConfig, owner=None
                 ) -> Tuple[Any, AdamWState, Dict[str, torch.Tensor]]:
    """Returns (new master weights (fp32; `cast_like` gives the live
    params), new state, {"grad_norm", "lr"}).  ``owner``: ``grads`` and
    ``state`` are one rank's shards (`global_norm`'s ``owner``); the
    update is elementwise, so it runs on the shards as it is.

    The state's mu / nu / master tensors are updated in place and returned
    in the new state: the call consumes ``state``, as the reference's
    ``jax.jit(..., donate_argnums=(0, 1))`` consumes it (at full width the
    fp32 state is 12 bytes per parameter, and a second copy would not fit
    one card).  Each update is the reference's expression, operation for
    operation (no fused multiply-add), so the numbers are its numbers."""
    step = state.step + 1
    gnorm = global_norm(grads, owner)
    scale = (torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
             if cfg.clip_norm > 0 else torch.ones((), device=gnorm.device))
    lr = lr_schedule(cfg, step)
    b1c = 1 - cfg.b1 ** step.float()
    b2c = 1 - cfg.b2 ** step.float()

    def upd(g, m, v, w):
        g = g.float() * scale
        m.mul_(cfg.b1).add_((1 - cfg.b1) * g)
        v.mul_(cfg.b2).add_((1 - cfg.b2) * g * g)
        w.sub_(lr * ((m / b1c) / (torch.sqrt(v / b2c) + cfg.eps) + cfg.weight_decay * w))

    tree_map(upd, grads, state.mu, state.nu, state.master)
    return state.master, AdamWState(step=step, master=state.master, mu=state.mu, nu=state.nu), {
        "grad_norm": gnorm, "lr": lr}


def cast_like(master: Any, params_template: Any) -> Any:
    """The live params: the master weights in the template's dtypes, in
    storage of their own (the master tensors change in the next update)."""
    return tree_map(lambda w, p: w.to(dtype=p.dtype, copy=True), master, params_template)
