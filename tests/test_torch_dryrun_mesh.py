"""The dry run on JAX's production meshes (ROADMAP Queue 1 item 14) on
the CPU: a fake process group of 256 or 512 ranks in this process
(``launch.mesh.fake_mesh``), the cells' inputs as DTensors of rank 0's
meta shards.

  * against JAX's ``build_cell`` on ``AbstractMesh``es (no compile): each
    of the 32 cells' per-device argument bytes at full size on 16x16 and
    2x16x16 (the sum of JAX's ``shard_shape`` bytes), the parameters'
    layouts (JAX's FSDP decision) in every cell and variant, and
    ``logits_sharding``;
  * a fake (1, 1) mesh counts a cell's FLOPs as mesh "1" does, and no
    collective;
  * llama3.2-3b's ``train_4k`` and ``decode_32k`` at full size on 16x16,
    A2's gathers, the CLI's mesh flags, and no process group left behind
    (every cell at SMOKE through ``run_cell`` and the perf variants are in
    ``test_torch_dryrun_mesh_cells.py`` and ``test_torch_dryrun_pods_*.py``).

The fake mesh's counts against four real gloo ranks are in
``test_torch_sharding_ranks.py`` (its one four-rank launch).
"""
import json

import jax
import numpy as np
import pytest
import torch.distributed as dist
from jax.sharding import AbstractMesh as JAbstractMesh

from repro.models import registry as jreg
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import shardings as tsh
from repro_torch.models import partitioning as tpt
from repro_torch.models import registry as treg
from test_torch_dryrun import jdry  # noqa: F401  (fixture)
from test_torch_helpers import one_torch_thread  # noqa: F401  (autouse fixture)
from test_torch_sharding import assert_specs_equal, flat_j, flat_t

MESHES = {False: ((16, 16), ("data", "model")), True: ((2, 16, 16), ("pod", "data", "model"))}
MESH_IDS = ["16x16", "2x16x16"]

#: JAX's per-device argument bytes (sums of ``shard_shape`` bytes), as
#: computed on JAX's ``AbstractMesh``es.
JAX_ARGS = {("llama3.2-3b", "train_4k", False): 153_214_980,
            ("llama3.2-3b", "train_4k", True): 152_952_836,
            ("llama3.2-3b", "prefill_32k", False): 51_159_040,
            ("llama3.2-3b", "prefill_32k", True): 51_027_968,
            ("llama3.2-3b", "decode_32k", False): 1_929_946_016,
            ("llama3.2-3b", "decode_32k", True): 990_421_456,
            ("deepseek-moe-16b", "decode_32k", False): 4_023_165_856,
            ("deepseek-moe-16b", "decode_32k", True): 2_144_117_200,
            ("mamba2-130m", "long_500k", False): 410_977_540,
            ("mamba2-130m", "long_500k", True): 410_977_540}


def jmesh(multi_pod: bool):
    return JAbstractMesh(*MESHES[multi_pod])


def jax_shard_bytes(args, shardings) -> int:
    """Per-device bytes of JAX's inputs: each leaf's ``shard_shape``."""
    leaves = jax.tree.leaves(args)
    shards = jax.tree.leaves(shardings, is_leaf=lambda x: hasattr(x, "shard_shape"))
    assert len(leaves) == len(shards)
    return sum(int(np.prod(s.shard_shape(a.shape))) * np.dtype(a.dtype).itemsize
               for a, s in zip(leaves, shards))


@pytest.mark.parametrize("multi_pod", [False, True], ids=MESH_IDS)
@pytest.mark.parametrize("arch, shape", treg.runnable_cells())
def test_argument_bytes_equal_jax_shards(arch, shape, multi_pod, jdry):
    """The port's per-device argument bytes (its meta DTensor inputs on the
    fake mesh, rank 0's shards; the step is not run) equal the sum of
    JAX's ``shard_shape`` bytes over the same inputs, at full size."""
    _, _, args, in_sh, _, _ = jdry.build_cell(arch, shape, smoke=False, mesh=jmesh(multi_pod))
    want = jax_shard_bytes(args, in_sh)
    with mesh_lib.fake_production_mesh(multi_pod) as mesh:
        _, _, targs, _ = dryrun.build_cell(arch, shape, smoke=False, mesh=mesh)
        got = dryrun.tree_bytes(targs)
    assert not dist.is_initialized()
    assert got == want, (got, want)
    assert JAX_ARGS.get((arch, shape, multi_pod), want) == want


@pytest.mark.parametrize("variant", list(dryrun.VARIANTS))
def test_parameter_layouts_equal_jax(variant, jdry):
    """JAX's FSDP decision (from 1e9 parameters up, not B2's serving ones)
    in every cell of every variant: the parameters' specs on 16x16 equal
    the ``in_shardings`` JAX's ``build_cell`` gives them."""
    mj, mt = jmesh(False), tpt.AbstractMesh(*MESHES[False])
    decided = set()
    # the decision and the specs depend on the parameters and on whether
    # the step trains: each id's train cell and its first serving cell
    cells = [(a, s) for a, s in treg.runnable_cells()
             if s in ("train_4k", "prefill_32k")]
    for arch, shape in cells:
        _, _, _, in_sh, _, _ = jdry.build_cell(arch, shape, smoke=False, mesh=mj,
                                               variant=variant)
        _, _, _, params, n, fsdp = dryrun.cell_params(arch, shape, smoke=False,
                                                      variant=variant)
        got = tsh.param_shardings(mt, params, fsdp=fsdp)
        assert_specs_equal({k: s.spec for k, s in flat_t(got).items()},
                           {k: s.spec for k, s in flat_j(in_sh[0]).items()}, (arch, shape))
        decided.add((arch, fsdp))
    assert ("llama3.2-3b", True) in decided and ("mamba2-130m", False) in decided
    assert (("deepseek-v2-236b", False) in decided) == (variant == "B2")


@pytest.mark.parametrize("arch", treg.ARCH_IDS)
def test_logits_sharding_equals_jax(arch, jdry):
    for multi_pod in (False, True):
        mj, mt = jmesh(multi_pod), tpt.AbstractMesh(*MESHES[multi_pod])
        for batch in (32, 128, 1):
            want = jdry.logits_sharding(mj, jreg.get_config(arch), batch)
            got = dryrun.logits_sharding(mt, treg.get_config(arch), batch)
            assert tuple(got.spec) == tuple(want.spec), (multi_pod, batch)
    if arch == "llama3.2-3b":
        assert tuple(dryrun.logits_sharding(mt, treg.get_config(arch), 1).spec) == (
            None, None, "model")


SMOKE_STEPS = {"train": ShapeSpec("train", 32, 4, "train"),
               "prefill": ShapeSpec("prefill", 32, 2, "prefill"),
               "decode": ShapeSpec("decode", 256, 2, "decode")}


@pytest.mark.parametrize("kind", list(SMOKE_STEPS))
@pytest.mark.parametrize("arch", ["llama3.2-3b", "deepseek-v2-236b", "zamba2-1.2b",
                                  "whisper-large-v3"])
def test_a_one_by_one_mesh_counts_mesh_1(arch, kind):
    """A fake (1, 1) mesh counts the FLOPs, kernel calls and argument bytes
    of mesh "1" (no mesh), and no collective."""
    shape = SMOKE_STEPS[kind]
    cfg, fn, args, _ = dryrun.build_cell(arch, shape, smoke=True)
    plain, mem = dryrun.memory(fn, args)
    with mesh_lib.fake_mesh((1, 1), ("data", "model")) as mesh:
        cfg, fn, args, _ = dryrun.build_cell(arch, shape, smoke=True, mesh=mesh)
        one, mem1 = dryrun.memory(fn, args)
    assert not dist.is_initialized()
    assert one.flops == plain.flops and one.flops_by_op == plain.flops_by_op
    assert one.kernels == plain.kernels
    assert one.collectives["total"] == 0 and sum(one.collectives["counts"].values()) == 0
    assert mem1["argument_size_in_bytes"] == mem["argument_size_in_bytes"]


def test_fake_mesh_refuses_a_live_group_and_cleans_up():
    with mesh_lib.fake_mesh((2, 2), ("data", "model")) as mesh:
        assert dist.get_world_size() == 4 and mesh.size() == 4
        with pytest.raises(RuntimeError, match="initialized already"):
            with mesh_lib.fake_mesh((1, 1), ("data", "model")):
                pass
    assert not dist.is_initialized()
    with pytest.raises(ValueError):
        with mesh_lib.fake_mesh((2, 2), ("data",)):
            pass
    assert not dist.is_initialized()


def check_mesh_record(arch: str, shape: str, multi_pod: bool, out_dir) -> dict:
    """``run_cell`` of a SMOKE cell on a production mesh: an ``ok`` record
    with JAX's fields, written as ``<arch>__<shape>__<mesh>.json``, n_chips
    the mesh's, collectives counted (at least one in a train step), the
    roofline's collective term over :data:`dryrun.NET_BW`, and no process
    group left initialized."""
    rec = dryrun.run_cell(arch, shape, multi_pod=multi_pod, smoke=True, out_dir=str(out_dir))
    assert not dist.is_initialized()
    assert rec["ok"], rec.get("traceback")
    name = MESH_IDS[multi_pod]
    saved = json.loads((out_dir / f"{arch}__{shape}__{name}.json").read_text())
    assert saved["mesh"] == name and saved["n_chips"] == (512 if multi_pod else 256)
    for key in ("n_params", "memory", "flops_per_device", "bytes_per_device", "collectives",
                "model_flops_global", "t_compute", "t_memory", "t_collective",
                "useful_flops_frac", "bottleneck", "probe", "t_total_s"):
        assert key in saved, key
    coll = saved["collectives"]
    assert set(coll["by_op"]) == set(coll["counts"]) == set(dryrun.COLLECTIVES)
    assert coll["total"] == sum(coll["by_op"].values())
    assert saved["t_collective"] == coll["total"] / dryrun.NET_BW
    assert saved["useful_flops_frac"] == (
        saved["model_flops_global"] / saved["n_chips"] / saved["flops_per_device"])
    if saved["kind"] == "train":
        assert sum(coll["counts"].values()) >= 1 and coll["total"] > 0
    return saved


@pytest.fixture(scope="module")
def full_llama():
    """llama3.2-3b's full-size train_4k and decode_32k on 16x16, baseline
    and A2 (train), as ``run_cell`` records."""
    out = {}
    for shape, variant in (("train_4k", "baseline"), ("train_4k", "A2"),
                           ("decode_32k", "baseline")):
        out[shape, variant] = dryrun.run_cell("llama3.2-3b", shape, multi_pod=False,
                                              variant=variant)
        assert out[shape, variant]["ok"], out[shape, variant].get("traceback")
    assert not dist.is_initialized()
    return out


def test_llama_full_size_on_16x16(full_llama):
    """The full-size cells: JAX's argument bytes, FSDP's gathers and
    reduce-scatters in the train step, every rank's share of K7/K7b (its
    rows and heads: 2 x 28 K7 and 28 K7b calls, remat), and a decode step
    whose cache is written in place on each rank's shard."""
    train, dec = full_llama["train_4k", "baseline"], full_llama["decode_32k", "baseline"]
    assert train["memory"]["argument_size_in_bytes"] == JAX_ARGS["llama3.2-3b", "train_4k", False]
    assert dec["memory"]["argument_size_in_bytes"] == JAX_ARGS["llama3.2-3b", "decode_32k", False]
    counts = train["collectives"]["counts"]
    assert counts["all-gather"] > 0 and counts["reduce-scatter"] > 0 and counts["all-reduce"] > 0
    assert train["kernels"]["flash_attention"]["calls"] == 56
    assert train["kernels"]["flash_attention_bwd"]["calls"] == 28
    assert 0 < train["useful_flops_frac"] < 1
    assert dec["memory"]["alias_size_in_bytes"] > 0  # the cache, updated in place
    assert dec["collectives"]["counts"]["all-reduce"] >= 28  # the scores over Dh's ranks


def test_a2_gathers_the_embedding_in_bf16(full_llama):
    """A2 casts the fp32 masters to bf16 before use. The port casts every
    matrix at use already, before its gather (a DTensor's ``.to`` is
    local), except the embedding table, which ``layers.embed`` gathers
    whole before its rows are read: A2 halves that table's two gathers
    (over "data", then "model") and changes no FLOP."""
    base, a2 = full_llama["train_4k", "baseline"], full_llama["train_4k", "A2"]
    cfg = treg.get_config("llama3.2-3b")
    table = cfg.vocab * cfg.d_model
    fp32 = 4 * (table // 16 + table)  # the gather over "data" (vocab/16 rows), then "model"
    assert base["flops_per_device"] == a2["flops_per_device"]
    assert (base["collectives"]["by_op"]["all-gather"] - a2["collectives"]["by_op"]["all-gather"]
            == fp32 // 2)


def test_cli_mesh_flags(monkeypatch, tmp_path):
    """``--both`` writes a cell's 16x16 and 2x16x16 records, ``--multi-pod``
    the second alone, no flag the one-card record, and ``--skip-done``
    runs nothing already ``ok``."""
    def main(*flags):
        monkeypatch.setattr("sys.argv", ["dryrun", "--arch", "stablelm-1.6b", "--shape",
                                         "decode_32k", "--smoke", "--out", str(tmp_path),
                                         *flags])
        with pytest.raises(SystemExit) as e:
            dryrun.main()
        assert e.value.code == 0
        assert not dist.is_initialized()

    main("--both")
    names = {p.name for p in tmp_path.iterdir()}
    assert names == {"stablelm-1.6b__decode_32k__16x16.json",
                     "stablelm-1.6b__decode_32k__2x16x16.json"}
    before = {p.name: p.stat().st_mtime_ns for p in tmp_path.iterdir()}
    main("--both", "--skip-done")
    assert {p.name: p.stat().st_mtime_ns for p in tmp_path.iterdir()} == before
    main()
    assert json.loads((tmp_path / "stablelm-1.6b__decode_32k__1.json").read_text())["ok"]
    main("--multi-pod")
    assert json.loads((tmp_path / "stablelm-1.6b__decode_32k__2x16x16.json").read_text())[
        "n_chips"] == 512
