"""hymba-1.5b's and llava-next-34b's prefill_32k cells of the port's dry run
on the fake (data 16, model 16) mesh: the bars and the derived
collectives of `tests/test_torch_dryrun_families.py`, in a file of their
own so that the four cells' minutes of fake-tensor prefill spread over
two workers."""
from __future__ import annotations

import pytest

from tests.test_torch_dryrun_families import check_prefill_cell


@pytest.mark.parametrize("arch", ["hymba-1.5b", "llava-next-34b"])
def test_family_prefill_cell_executes_its_step(arch):
    check_prefill_cell(arch)
