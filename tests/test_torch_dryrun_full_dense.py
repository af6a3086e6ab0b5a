"""The port's dry run at full size on meta (no card, nothing allocated)
for the dense, vlm and encdec ids: every cell's ``run_cell`` record is
``ok`` (``dryrun_cells.check_full_cell``)."""
import pytest

import dryrun_cells
from repro_torch.models import registry
from test_torch_helpers import one_torch_thread  # noqa: F401  (autouse fixture)

IDS = ("granite-3-8b", "stablelm-1.6b", "internlm2-20b", "llama3.2-3b", "pixtral-12b",
       "whisper-large-v3")


@pytest.mark.parametrize("arch, shape", [c for c in registry.runnable_cells() if c[0] in IDS])
def test_run_cell_full_size(arch, shape, tmp_path):
    dryrun_cells.check_full_cell(arch, shape, tmp_path)
