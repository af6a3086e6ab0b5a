"""The port's dry run at full size on meta (no card, nothing allocated)
for deepseek-v2-236b (MLA-MoE), its train step, the longest cell (its
serving cells are in ``test_torch_dryrun_full_mla_serve.py``): the
``run_cell`` record is ``ok`` (``dryrun_cells.check_full_cell``)."""
import pytest

import dryrun_cells
from test_torch_helpers import one_torch_thread  # noqa: F401  (autouse fixture)


@pytest.mark.parametrize("shape", ("train_4k",))
def test_run_cell_full_size(shape, tmp_path):
    dryrun_cells.check_full_cell("deepseek-v2-236b", shape, tmp_path)
