"""The dry run's cells at SMOKE on JAX's two-pod 2x16x16 mesh ("pod",
"data", "model"; a fake process group of 512 ranks) for the encdec, hybrid, vlm and SSM ids:
``test_torch_dryrun_mesh.check_mesh_record`` of each."""
import pytest

from repro_torch.models import registry as treg
from test_torch_dryrun_mesh import check_mesh_record
from test_torch_helpers import one_torch_thread  # noqa: F401  (autouse fixture)

IDS = ("whisper-large-v3", "zamba2-1.2b", "pixtral-12b", "mamba2-130m")


@pytest.mark.parametrize("arch, shape", [c for c in treg.runnable_cells(smoke=True) if c[0] in IDS])
def test_run_cell_2x16x16_smoke(arch, shape, tmp_path):
    check_mesh_record(arch, shape, True, tmp_path)
