"""The dry run's cells at SMOKE on JAX's 16x16 mesh (a fake process group
of 256 ranks): every cell of ``registry.runnable_cells`` through
``run_cell`` (``test_torch_dryrun_mesh.check_mesh_record``: an ``ok``
record with JAX's fields, collectives counted, no process group left),
and every perf variant on llama3.2-3b's train and decode cells."""
import pytest
import torch.distributed as dist

from repro_torch.launch import dryrun
from repro_torch.models import registry as treg
from test_torch_dryrun_mesh import check_mesh_record
from test_torch_helpers import one_torch_thread  # noqa: F401  (autouse fixture)


@pytest.mark.parametrize("arch, shape", treg.runnable_cells(smoke=True))
def test_run_cell_16x16_smoke(arch, shape, tmp_path):
    check_mesh_record(arch, shape, False, tmp_path)


@pytest.mark.parametrize("variant", list(dryrun.VARIANTS))
def test_variants_on_16x16(variant, tmp_path):
    """Every perf variant runs llama3.2-3b's train_4k and decode_32k on
    16x16 (SMOKE); B1 and B2 decode through K6 on each rank's blocks."""
    for shape in ("train_4k", "decode_32k"):
        rec = dryrun.run_cell("llama3.2-3b", shape, multi_pod=False, smoke=True,
                              variant=variant, out_dir=str(tmp_path))
        assert rec["ok"], rec.get("traceback")
        assert not dist.is_initialized()
        suffix = "" if variant == "baseline" else f"__{variant}"
        assert (tmp_path / f"llama3.2-3b__{shape}__16x16{suffix}.json").exists()
        if shape == "decode_32k":
            assert ("rcll_kv_decode" in rec["kernels"]) == (variant in ("B1", "B2"))
