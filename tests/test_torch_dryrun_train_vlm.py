"""The VLM arch's train_4k cell of the port's dry run on the single
production mesh (data 16, model 16), in a file of its own (~90 s of host
time on fake tensors): `tests/test_torch_dryrun_train.py`'s
``executed_train_cell`` bars, and llava's sequence: the 2880 image
positions and 1216 text tokens cut together into slices of 256 (the
embedding's reduce-scatter onto the rank's slice of the prefix ‖ text
rows), the xent over the 1215 text labels a row only."""
from __future__ import annotations

from repro_torch.configs import SHAPES, get_config
from tests.test_torch_dryrun_train import executed_train_cell


def test_vlm_train_cell_executes_its_step():
    cfg = get_config("llava-next-34b")
    rows = SHAPES["train_4k"].global_batch // 16
    rec = executed_train_cell("llava-next-34b", False)
    g = rec["executed"]["collectives_by_group"]
    L, D = cfg.n_layers, cfg.d_model
    assert g["model"]["reduce_scatter"]["calls"] == 3 * L + 2
    # every reduce-scatter onto the slice: (rows, 4096 / 16, D)
    assert g["model"]["reduce_scatter"]["elements"] == (3 * L + 2) * rows * 256 * D
