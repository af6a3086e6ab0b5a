"""The port's dry run at full size on meta (no card, nothing allocated)
for the ssm, hybrid and MoE ids: every cell's ``run_cell`` record is
``ok`` (``dryrun_cells.check_full_cell``)."""
import pytest

import dryrun_cells
from repro_torch.models import registry
from test_torch_helpers import one_torch_thread  # noqa: F401  (autouse fixture)

IDS = ("mamba2-130m", "zamba2-1.2b", "deepseek-moe-16b")


@pytest.mark.parametrize("arch, shape", [c for c in registry.runnable_cells() if c[0] in IDS])
def test_run_cell_full_size(arch, shape, tmp_path):
    dryrun_cells.check_full_cell(arch, shape, tmp_path)
