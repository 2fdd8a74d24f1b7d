"""The MoE and encoder-decoder archs' train_4k cells of the port's dry run
on the single production mesh (data 16, model 16), in a file of their own
(a cell's forward, recompute and backward on fake tensors take ~40 s of
host time): `tests/test_torch_dryrun_train.py`'s ``executed_train_cell``
bars (executed, fits, the rules' argument bytes, the derived contract),
and the collectives each family adds to the dense step's:

- granite-moe-1b-a400m: per layer the router's columns gathered over
  ``model`` in the forward and the recompute, the expert counts gathered
  over the rows' group, the aux loss's P̄ summed over the world, each
  twice, beside the global norm's one scalar;
- whisper-small: the encoder over each rank's rows' whole 1500 frames,
  its MLP's partial sums all-reduced over ``model`` both ways (two a
  layer) and no sequence collective, cross attention from the decoder's
  slice with no collective.
"""
from __future__ import annotations

import pytest

from repro_torch.configs import SHAPES, get_config
from tests.test_torch_dryrun_train import executed_train_cell

ARCHS = ["granite-moe-1b-a400m", "whisper-small"]


@pytest.mark.parametrize("arch", ARCHS)
def test_family_train_cell_executes_its_step(arch):
    cfg = get_config(arch)
    L, rows = cfg.n_layers, SHAPES["train_4k"].global_batch // 16
    g = executed_train_cell(arch, False)["executed"]["collectives_by_group"]
    if arch == "granite-moe-1b-a400m":
        E = cfg.moe.num_experts
        assert g["world"]["all_reduce"] == {"calls": 2 * L + 1, "elements": 2 * L * E + 1,
                                            "bytes": 4 * (2 * L * E + 1)}
        # seven weights a layer gathered (FSDP) and the counts, each twice,
        # and the tied table twice
        assert g["data"]["all_gather"]["calls"] == 16 * L + 2
    else:
        enc = 2 * cfg.n_encoder_layers * rows * cfg.encoder_seq_len * cfg.d_model
        assert g["model"]["all_reduce"]["elements"] >= enc
        assert g["model"]["all_gather"]["calls"] == 5 * L + 2
