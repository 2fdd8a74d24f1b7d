"""Training step: loss, grads, AdamW (the port of
``repro.training.train_loop``).

The loss is next-token cross-entropy (+ the MoE aux loss); gemma2's logit
softcap is inside the model.  The step is params-functional, as the
reference's: (params, opt_state, batch) → (params, opt_state, metrics),
with ``torch.autograd`` in place of ``jax.value_and_grad``.  Like the
reference's jitted step with ``donate_argnums=(0, 1)``, it consumes the
optimizer state it is given (`adamw_update` updates it in place).
"""
from __future__ import annotations

from functools import partial
from typing import Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import forward_train
from repro_torch.training.optimizer import (
    AdamWState,
    OptimizerConfig,
    adamw_update,
    cast_like,
    tree_map,
)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean next-token xent; logits (B, S, V) fp32, labels (B, S)."""
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return (logz - gold).mean()


def loss_fn(params, batch: Dict[str, torch.Tensor], cfg: ModelConfig, remat: bool = True):
    logits, aux = forward_train(params, batch, cfg, remat=remat)
    tokens = batch["tokens"]
    xent = cross_entropy(logits[:, :-1], tokens[:, 1:])
    total = xent + cfg.moe.router_aux_coef * aux
    return total, {"xent": xent, "aux": aux}


def train_step(params, opt_state: AdamWState, batch: Dict[str, torch.Tensor],
               cfg: ModelConfig, ocfg: OptimizerConfig, remat: bool = True
               ) -> Tuple[dict, AdamWState, Dict[str, torch.Tensor]]:
    """One step.  A leaf the loss does not reach (hybrid's ``ssm_out_norm``,
    which the reference's forward never reads) gets a zero gradient, as
    ``jax.grad`` gives it."""
    live = tree_map(lambda x: x.detach().requires_grad_(True), params)
    loss, parts = loss_fn(live, batch, cfg, remat)
    loss.backward()
    grads = tree_map(lambda x: x.grad if x.grad is not None else torch.zeros_like(x), live)
    del live
    master, opt_state, opt_metrics = adamw_update(grads, opt_state, ocfg)
    new_params = cast_like(master, params)
    metrics = {"loss": loss.detach(), **{k: v.detach() for k, v in parts.items()},
               **opt_metrics}
    return new_params, opt_state, metrics


def make_train_step(cfg: ModelConfig, ocfg: OptimizerConfig, remat: bool = True):
    return partial(train_step, cfg=cfg, ocfg=ocfg, remat=remat)
