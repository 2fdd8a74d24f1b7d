"""The dense archs' train_4k cells of the port's dry run
(`repro_torch.launch.dryrun`), in a file of their own: a cell's forward,
recompute and backward on fake tensors take ~40-55 s of host time
(`executed_train_cell` is the bar the other families' files,
`tests/test_torch_dryrun_train_*.py`, hold their cells to).

Each cell executes ``build_cell(...).fn`` (`repro_torch.launch.specs.
train_step`: the port's `train_step` on rank 0's shards under
``train_rules``, with remat) on the rules' arguments on the fake
production mesh, with grad enabled: the step's argument bytes are the
rules' (`specs.build_cell`'s ``arg_bytes_per_rank``, which
`tests/test_torch_dryrun.py` holds equal to the reference's for every
cell); its peak counts the saved activations, the gradients and the
backward's temporaries, and fits an H100; its collectives are those
`dryrun.train_collectives` derives (the record's ``contract``).
"""
from __future__ import annotations

import pytest

from repro_torch.configs import SHAPES, get_config
from repro_torch.distributed import step_stats
from repro_torch.launch import dryrun, specs

CELLS = [("granite-3-2b", False), ("gemma2-9b", False), ("granite-3-2b", True)]
AXES = {False: {"data": 16, "model": 16}, True: {"pod": 2, "data": 16, "model": 16}}


def executed_train_cell(arch: str, multi: bool) -> dict:
    """The train_4k cell's record, held to what every train cell holds:
    executed, fits, the rules' argument bytes, its derived contract, a peak
    above the arguments plus the gradients.  Returns the record."""
    cfg = get_config(arch)
    rec = dryrun.run_cell(arch, "train_4k", multi, dev_bytes=dryrun.H100_BYTES)
    with step_stats.fake_tensors():
        cell = specs.build_cell(cfg, SHAPES["train_4k"], AXES[multi])
        want, params = cell.arg_bytes_per_rank, specs.tree_bytes(cell.args[0])
    ex = rec["executed"]
    assert rec["status"] == "ok" and rec["fits"] is True
    assert rec["memory"]["argument_bytes"] == ex["memory"]["argument_bytes"] == want
    assert ex["step"].startswith("repro_torch.training.train_loop.train_step")
    assert ex["contract"] and all(ex["contract"].values()), ex["contract"]
    # the gradients alone take the params' bytes beside the arguments
    assert ex["memory"]["argument_bytes"] + params < ex["memory"]["peak_bytes"]
    assert ex["memory"]["peak_bytes"] <= dryrun.H100_BYTES
    return rec


@pytest.mark.parametrize("arch,multi", CELLS,
                         ids=[f"{a}-{'multi' if m else 'single'}" for a, m in CELLS])
def test_dense_train_cell_executes_its_step(arch, multi):
    cfg = get_config(arch)
    g = executed_train_cell(arch, multi)["executed"]["collectives_by_group"]
    fsdp = "data_in_pod" if multi else "data"
    assert g[fsdp]["all_gather"]["calls"] == 14 * cfg.n_layers + 2
    assert g["model"]["reduce_scatter"]["calls"] == 3 * cfg.n_layers + 2
    assert g["world"]["all_reduce"] == {"calls": 1, "elements": 1, "bytes": 4}
    assert ("pod" in g) == multi
