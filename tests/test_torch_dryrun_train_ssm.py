"""The SSM arch's train_4k cell of the port's dry run on the single
production mesh (data 16, model 16), in a file of its own (the SSD scan's
chunk loop, forward, recompute and backward, on fake tensors takes ~60 s
of host time): `tests/test_torch_dryrun_train.py`'s
``executed_train_cell`` bars, and mamba2's collectives over ``model`` per
layer: the normed input gathered over the sequence (the scan crosses the
slices' edges), ``in_proj``'s 8512 columns and the conv's 4352 channels
gathered (each in the forward and the recompute, its reduce-scatter in
the backward), the gated norm's Σx² over the rank's 4 of 64 heads summed
both ways, ``out_proj``'s partial product reduce-scattered onto the
slice."""
from __future__ import annotations

from repro_torch.configs import SHAPES, get_config
from tests.test_torch_dryrun_train import executed_train_cell


def test_ssm_train_cell_executes_its_step():
    cfg = get_config("mamba2-1.3b")
    L, rows, T = cfg.n_layers, SHAPES["train_4k"].global_batch // 16, 4096
    g = executed_train_cell("mamba2-1.3b", False)["executed"]["collectives_by_group"]
    # hn twice, in_proj and conv twice each, out_proj's reduce-scatter's pair
    assert g["model"]["all_gather"]["calls"] == 7 * L + 2
    # the xent's two, the gated norm's three a layer and the gradients of
    # the five leaves a layer whole over model (ln1, A_log, ssm_D, dt_bias,
    # ssm_norm) and final_norm
    assert g["model"]["all_reduce"]["calls"] == 8 * L + 3
    assert g["model"]["all_reduce"]["elements"] > 3 * L * rows * T
