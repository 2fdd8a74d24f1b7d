"""The hybrid arch's train_4k cell of the port's dry run on the single
production mesh (data 16, model 16), in a file of its own (the SSD scan
beside sequence-parallel attention, forward, recompute and backward, on
fake tensors): `tests/test_torch_dryrun_train.py`'s
``executed_train_cell`` bars, and hymba's collectives over ``model`` per
layer: one gather of the normed input shared by attention's K / V and the
SSD scan, its 3257 ``in_proj`` columns and 25 SSD heads whole (no gather,
no Σ sum), its 1632 conv channels gathered, ``out_proj``'s partial product
reduce-scattered onto the slice in the forward and again in the recompute
(the MLP comes after it), the MLP's once."""
from __future__ import annotations

from repro_torch.configs import get_config
from tests.test_torch_dryrun_train import executed_train_cell


def test_hybrid_train_cell_executes_its_step():
    cfg = get_config("hymba-1.5b")
    L = cfg.n_layers
    g = executed_train_cell("hymba-1.5b", False)["executed"]["collectives_by_group"]
    # hn and hn2 twice, the conv twice, the two reduce-scatters' pairs
    assert g["model"]["all_gather"]["calls"] == 8 * L + 2
    # out_proj twice and the MLP once, the three gathers' pairs
    assert g["model"]["reduce_scatter"]["calls"] == 6 * L + 2
