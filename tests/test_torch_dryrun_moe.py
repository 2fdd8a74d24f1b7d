"""The MoE archs' prefill_32k cells of the port's dry run
(`repro_torch.launch.dryrun`), in a file of their own so that their ~70 s
of fake-tensor prefill run beside `tests/test_torch_dryrun.py`.

Each cell executes ``build_cell(...).fn`` (the expert-parallel prefill) on
the fake (data 16, model 16) mesh on the rules' arguments: the step's
argument bytes are the rules' (`specs.build_cell`'s ``arg_bytes_per_rank``,
which `tests/test_torch_dryrun.py` holds equal to the reference's for
every cell); per MoE layer one all-gather of the expert counts over
``data`` and one of the router's columns over ``model``, and one
all-reduce of the experts' outputs over ``model``; the peak fits an H100.
"""
from __future__ import annotations

import pytest

from repro_torch.configs import SHAPES, get_config
from repro_torch.distributed import step_stats
from repro_torch.launch import dryrun, specs

MOE = ["granite-moe-1b-a400m", "qwen3-moe-30b-a3b"]


@pytest.mark.parametrize("arch", MOE)
def test_moe_prefill_cell_executes_expert_parallel(arch):
    cfg = get_config(arch)
    rec = dryrun.run_cell(arch, "prefill_32k", False, dev_bytes=dryrun.H100_BYTES)
    with step_stats.fake_tensors():
        want = specs.build_cell(cfg, SHAPES["prefill_32k"],
                                {"data": 16, "model": 16}).arg_bytes_per_rank
    ex = rec["executed"]
    assert rec["status"] == "ok" and rec["fits"] is True
    assert rec["memory"]["argument_bytes"] == ex["memory"]["argument_bytes"] == want
    assert ex["step"].startswith("repro_torch.serving.engine.prefill")
    L, E, D = cfg.n_layers, cfg.moe.num_experts, cfg.d_model
    g = ex["collectives_by_group"]
    assert g["data"]["all_gather"] == {"calls": L, "elements": L * 16 * 3 * E,
                                       "bytes": 8 * L * 16 * 3 * E}
    # the embedding, each layer's experts and the replica-0 slot weights'
    # gathers (as the dense prefill's) beside the routers'
    assert g["model"]["all_reduce"]["calls"] == L + 1
    assert g["model"]["all_gather"]["calls"] > L + 1
    assert ex["memory"]["peak_bytes"] <= dryrun.H100_BYTES
