"""The check the ``test_torch_dryrun_full_*.py`` files run on each cell
of the port's dry run at full size on meta (the cells split over three
files so that each runs well inside a worker's share of the suite)."""
import json

from repro_torch.configs.shapes import SHAPES
from repro_torch.launch import dryrun
from repro_torch.models import registry


def check_full_cell(arch: str, shape: str, tmp_path) -> dict:
    """``run_cell`` writes an ``ok`` record for the full-size cell, with
    JAX's fields, no collective, FLOPs above zero and the arguments'
    bytes those of the abstract parameters (with the AdamW moments, the
    step and the batch for a train step, the tokens and cache for a decode
    step, the tokens and stubs for a prefill)."""
    rec = dryrun.run_cell(arch, shape, out_dir=str(tmp_path))
    assert rec["ok"], rec.get("traceback")
    with open(tmp_path / f"{arch}__{shape}__1.json") as f:
        assert json.load(f)["ok"]
    cfg = registry.get_config(arch)
    params = dryrun.tree_bytes(registry.abstract_params(cfg))
    specs = dryrun.tree_bytes(registry.input_specs(cfg, SHAPES[shape]))
    mem = rec["memory"]
    want = 3 * params + 4 + specs if rec["kind"] == "train" else params + specs
    assert mem["argument_size_in_bytes"] == want
    assert rec["flops_per_device"] > 0 and rec["t_collective"] == 0.0
    assert rec["bottleneck"] in ("compute", "memory")
    print(f"{arch} {shape}: {rec['t_total_s']} s, {rec['flops_per_device']:.4g} FLOPs, "
          f"{rec['bytes_per_device']:.4g} bytes, temp {mem['temp_size_in_bytes']}")
    return rec
