"""The port's dry run at full size on meta (no card, nothing allocated)
for deepseek-v2-236b (MLA-MoE), its prefill and decode steps:
the ``run_cell`` record is ``ok`` (``dryrun_cells.check_full_cell``)."""
import pytest

import dryrun_cells
from test_torch_helpers import one_torch_thread  # noqa: F401  (autouse fixture)


@pytest.mark.parametrize("shape", ("prefill_32k", "decode_32k"))
def test_run_cell_full_size(shape, tmp_path):
    dryrun_cells.check_full_cell("deepseek-v2-236b", shape, tmp_path)
