"""The SSM, hybrid, encoder-decoder and VLM archs' prefill_32k cells of the
port's dry run (`repro_torch.launch.dryrun`), in files of their own so
that their minutes of fake-tensor prefill run beside
`tests/test_torch_dryrun.py` and each other: mamba2 and whisper here,
hymba and llava in `tests/test_torch_dryrun_families_attn.py`.

Each cell executes ``build_cell(...).fn`` (the prefill on the rank's
shards) on the fake (data 16, model 16) mesh on the rules' arguments: the
step's argument bytes are the rules' (`specs.build_cell`'s
``arg_bytes_per_rank``, which `tests/test_torch_dryrun.py` holds equal to
the reference's for every cell), and its peak fits an H100.  Per rank,
over ``model``, nothing over ``data``:

- mamba2: per layer two all-gathers (in_proj's columns, the conv's
  activated channels) and two all-reduces (the gated norm's Σ, out_proj);
- hymba: per layer the slot weights' four gathers (the prefill's
  attention runs on whole heads, as the dense prefill's) and the conv's,
  and two all-reduces (out_proj, the MLP);
- whisper: per decoder layer the slot weights' four gathers and the MLP's
  all-reduce, per encoder layer the MLP's (its 12 heads stay whole);
- llava: the dense prefill's (the image embeddings ride the rows);

beside the embedding's all-reduce and the argmax's pair gather.
"""
from __future__ import annotations

import pytest

from repro_torch.configs import SHAPES, get_config
from repro_torch.distributed import step_stats
from repro_torch.launch import dryrun, specs

# arch: (all-reduces, all-gathers) per decoder layer, and per encoder layer
PER_LAYER = {"mamba2-1.3b": ((2, 2), (0, 0)), "hymba-1.5b": ((2, 5), (0, 0)),
             "whisper-small": ((1, 4), (1, 0)), "llava-next-34b": ((1, 4), (0, 0))}


def check_prefill_cell(arch: str) -> None:
    """``arch``'s prefill_32k cell's record (module docstring)."""
    cfg = get_config(arch)
    rec = dryrun.run_cell(arch, "prefill_32k", False, dev_bytes=dryrun.H100_BYTES)
    with step_stats.fake_tensors():
        want = specs.build_cell(cfg, SHAPES["prefill_32k"],
                                {"data": 16, "model": 16}).arg_bytes_per_rank
    ex = rec["executed"]
    assert rec["status"] == "ok" and rec["fits"] is True
    assert rec["memory"]["argument_bytes"] == ex["memory"]["argument_bytes"] == want
    assert ex["step"].startswith("repro_torch.serving.engine.prefill")
    assert ex["memory"]["peak_bytes"] <= dryrun.H100_BYTES
    (ar, ag), (enc_ar, enc_ag) = PER_LAYER[arch]
    g = ex["collectives_by_group"]
    assert set(g) == {"model"}
    assert g["model"]["all_reduce"]["calls"] == (ar * cfg.n_layers + 1
                                                 + enc_ar * cfg.n_encoder_layers)
    assert g["model"]["all_gather"]["calls"] == (ag * cfg.n_layers + 1
                                                 + enc_ag * cfg.n_encoder_layers)


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "whisper-small"])
def test_family_prefill_cell_executes_its_step(arch):
    check_prefill_cell(arch)
