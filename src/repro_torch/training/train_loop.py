"""Training step: loss, grads, AdamW (the port of
``repro.training.train_loop``).

The loss is next-token cross-entropy (+ the MoE aux loss); gemma2's logit
softcap is inside the model.  The step is params-functional, as the
reference's: (params, opt_state, batch) → (params, opt_state, metrics),
with ``torch.autograd`` in place of ``jax.value_and_grad``.  Like the
reference's jitted step with ``donate_argnums=(0, 1)``, it consumes the
optimizer state it is given (`adamw_update` updates it in place).

On a rank's shards under ``train_rules`` (``shards``, a
`repro_torch.distributed.sharding.TrainShards`, with the params' spec
tree; the train cells' step, `repro_torch.launch.specs.train_step`) the
same step runs on the rank's rows, parameter shards and optimizer state
shards:

- the cross-entropy is vocab-parallel (`vocab_parallel_xent`) over the
  rank's columns of the logits, and the mean is over the global B·(T−1)
  tokens: the rank's sum over its rows, divided by the global count (its
  metric summed over the rows' group, outside autograd);
- an MoE's aux loss is global on every rank and back-propagates into the
  rank's own positions only (`repro_torch.models.moe`), so each rank's
  loss carries it whole and the metrics count it once;
- a parameter's gradient is summed over the groups its spec replicates it
  on (`replicated_over`: ``model`` and ``data`` where no dim splits over
  them, ``pod`` always) by an all-reduce in the backward
  (`comm.all_reduce_grad`); the groups it splits over sum it in the
  backward of the gathers that read it;
- the global norm counts each element once (`optimizer.global_norm`'s
  ``owner``), and AdamW updates the shards elementwise.

A group of one issues nothing, so one rank of a (1, 1) mesh runs the local
step's expressions.
"""
from __future__ import annotations

from functools import partial
from typing import Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import comm
from repro_torch.distributed.sharding import replicated_over
from repro_torch.models import forward_train
from repro_torch.training.optimizer import (
    AdamWState,
    OptimizerConfig,
    adamw_update,
    cast_like,
    tree_map,
)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor, shards=None) -> torch.Tensor:
    """Mean next-token xent; logits (B, S, V) fp32, labels (B, S).  On a
    train step's shards: the rank's share of the global mean (logits of its
    rows, over its vocab columns when the vocab splits)."""
    if shards is None or shards.vocab.group is None:
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
        per_token = logz - gold
    else:
        v = shards.vocab
        per_token = vocab_parallel_xent(logits, labels, v.offset(logits.shape[-1]), v.group)
    if shards is None or shards.batch.group is None:
        return per_token.mean()
    return per_token.sum() / (per_token.numel() * shards.batch.size)


class _VocabParallelXent(torch.autograd.Function):
    """Per-token xent over logits whose vocab columns split over a group:
    the max and Σexp all-reduced, the gold logit from the rank that holds
    the label.  The backward is (softmax − one-hot) on the rank's columns
    and issues nothing: every rank computes the same per-token loss, so a
    collective inside autograd would multiply the gradient by the group's
    size."""

    @staticmethod
    def forward(ctx, logits, labels, v0, group):
        n = logits.shape[-1]
        m = comm.all_reduce_max(logits.amax(dim=-1), group)
        e = torch.exp(logits - m[..., None])
        local = labels.long() - v0
        hit = (local >= 0) & (local < n)
        idx = torch.where(hit, local, 0)[..., None]
        gold = torch.where(hit, torch.gather(logits, -1, idx)[..., 0], 0.0)
        sums = comm.all_reduce_sum(torch.stack([e.sum(dim=-1), gold], dim=-1), group)
        p = e.div_(sums[..., :1])
        ctx.save_for_backward(p, idx, hit)
        return m + torch.log(sums[..., 0]) - sums[..., 1]

    @staticmethod
    def backward(ctx, g):
        p, idx, hit = ctx.saved_tensors
        d = p * g[..., None]
        d.scatter_add_(-1, idx, -(g * hit)[..., None])
        return d, None, None, None


def vocab_parallel_xent(logits: torch.Tensor, labels: torch.Tensor, v0: int,
                        group) -> torch.Tensor:
    """Per-token next-token xent (B, S) of fp32 ``logits`` (B, S, V_l), the
    columns [v0, v0 + V_l) of a vocab split over ``group``, at ``labels``
    (B, S) global ids."""
    return _VocabParallelXent.apply(logits, labels, v0, group)


def loss_fn(params, batch: Dict[str, torch.Tensor], cfg: ModelConfig, remat: bool = True,
            shards=None):
    logits, aux = forward_train(params, batch, cfg, remat=remat, shards=shards)
    tokens = batch["tokens"]
    xent = cross_entropy(logits[:, :-1], tokens[:, 1:], shards)
    total = xent + cfg.moe.router_aux_coef * aux
    return total, {"xent": xent, "aux": aux}


def train_step(params, opt_state: AdamWState, batch: Dict[str, torch.Tensor],
               cfg: ModelConfig, ocfg: OptimizerConfig, remat: bool = True,
               shards=None, specs=None) -> Tuple[dict, AdamWState, Dict[str, torch.Tensor]]:
    """One step.  A leaf the loss does not reach (hybrid's ``ssm_out_norm``,
    which the reference's forward never reads) gets a zero gradient, as
    ``jax.grad`` gives it.  ``shards`` / ``specs``: the step on a rank's
    shards (the module docstring); the metrics are then global, the same
    on every rank."""
    live = tree_map(lambda x: x.detach().requires_grad_(True), params)
    used, owner = live, None
    if shards is not None:
        used = tree_map(lambda x, spec: _replicated(x, spec, shards.mesh), live, specs)
        owner = _owner(params, specs, shards.mesh)
    loss, parts = loss_fn(used, batch, cfg, remat, shards)
    loss.backward()
    grads = tree_map(lambda x: x.grad if x.grad is not None else torch.zeros_like(x), live)
    del live, used
    master, opt_state, opt_metrics = adamw_update(grads, opt_state, ocfg, owner)
    new_params = cast_like(master, params)
    metrics = {"loss": loss.detach(), **{k: v.detach() for k, v in parts.items()}}
    if shards is not None and shards.batch.group is not None:
        # the xent shares summed over the rows; the aux is global already
        xent = comm.all_reduce_sum(metrics["xent"].clone(), shards.batch.group)
        metrics = {"loss": xent + cfg.moe.router_aux_coef * metrics["aux"], "xent": xent,
                   "aux": metrics["aux"]}
    return new_params, opt_state, {**metrics, **opt_metrics}


def _replicated(x: torch.Tensor, spec, mesh) -> torch.Tensor:
    """``x`` whose gradient is summed over the groups ``spec`` replicates it
    on (`replicated_over`)."""
    for group in replicated_over(spec, mesh):
        x = comm.all_reduce_grad(x, group)
    return x


def _owner(params, specs, mesh):
    """`global_norm`'s ``owner`` on ``mesh``'s rank: per leaf of ``params``
    whether the rank counts its shard (index 0 in every group ``specs``
    replicate the leaf on), and the group that sums the counts (every
    rank); None on a mesh of one rank."""
    if mesh.world == 1:
        return None
    counts = tree_map(lambda _, spec: all(g.rank == 0 for g in replicated_over(spec, mesh)),
                      params, specs)
    return counts, mesh.world_group


def make_train_step(cfg: ModelConfig, ocfg: OptimizerConfig, remat: bool = True):
    return partial(train_step, cfg=cfg, ocfg=ocfg, remat=remat)
