"""The dry run on one card (ROADMAP Queue 1 item 12) against the JAX
package, on the CPU: ``configs/shapes.py``, the registry's abstract specs
(meta tensors against ``jax.eval_shape``), ``model_flops``, ``VARIANTS``;
the cost counter (``kernels.cost``): a SMOKE step counts the same FLOPs,
bytes and memory on meta as on CPU tensors, its aten FLOPs are
``FlopCounterMode``'s, and K6, K7 and K7b count their formulas; the
kernels' meta paths; ``run_cell`` at SMOKE for all 32 cells (the cells at
full size are in ``test_torch_dryrun_full_*.py``); and the MoE expert
counts that replace ``torch.bincount`` (which meta cannot run)."""
import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro.configs import shapes as jshapes
from repro.models import registry as jreg
from repro_torch.configs import shapes as tshapes
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.kernels import cost
from repro_torch.kernels import flash_attention as k7
from repro_torch.kernels import rcll_kv_attention as k6
from repro_torch.launch import dryrun
from repro_torch.models import moe as tmoe
from repro_torch.models import registry as treg
from repro_torch.optim import adamw
from test_torch_helpers import one_torch_thread  # noqa: F401  (autouse fixture)


@pytest.fixture(scope="module")
def jdry():
    """JAX's ``repro.launch.dryrun``, imported with JAX's backend already
    up (its first lines set XLA_FLAGS for 512 fake devices; the variable is
    put back, so nothing else in this process sees it)."""
    jax.devices()
    flags = os.environ.get("XLA_FLAGS")
    from repro.launch import dryrun as mod
    if flags is None:
        os.environ.pop("XLA_FLAGS", None)
    else:
        os.environ["XLA_FLAGS"] = flags
    return mod


def _path(entry) -> str:
    for attr in ("key", "name", "idx"):
        if hasattr(entry, attr):
            return str(getattr(entry, attr))
    raise TypeError(entry)


def jax_leaves(tree) -> dict:
    """{dotted path: (shape, dtype name)} of a JAX pytree of abstract values."""
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {".".join(_path(e) for e in p): (tuple(v.shape), np.dtype(v.dtype).name)
            for p, v in leaves}


def torch_leaves(tree, prefix: str = "") -> dict:
    """The same of a nested dict / NamedTuple of the port's meta tensors."""
    if isinstance(tree, torch.Tensor):
        return {prefix[:-1]: (tuple(tree.shape), str(tree.dtype).split(".")[-1])}
    if isinstance(tree, dict):
        items = tree.items()
    elif hasattr(tree, "_fields"):
        items = tree._asdict().items()
    else:
        items = enumerate(tree)
    out = {}
    for k, v in items:
        out.update(torch_leaves(v, f"{prefix}{k}."))
    return out


def test_shapes_equal_jax():
    assert tshapes.SHAPES == {k: ShapeSpec(**dataclasses.asdict(v))
                              for k, v in jshapes.SHAPES.items()}
    assert tshapes.LONG_OK_FAMILIES == jshapes.LONG_OK_FAMILIES
    for fam in ("dense", "moe", "mla_moe", "vlm", "ssm", "hybrid", "encdec"):
        for name in tshapes.SHAPES:
            assert tshapes.runnable(fam, name) == jshapes.runnable(fam, name)


@pytest.mark.parametrize("smoke", [False, True])
def test_runnable_cells_equal_jax(smoke):
    cells = treg.runnable_cells(smoke=smoke)
    assert cells == jreg.runnable_cells(smoke=smoke) and len(cells) == 32


@pytest.mark.parametrize("arch", treg.ARCH_IDS)
def test_abstract_params_equal_jax(arch):
    """Every leaf's key path, shape and dtype at full size; nothing allocated."""
    got = treg.abstract_params(treg.get_config(arch))
    want = jax_leaves(jreg.abstract_params(jreg.get_config(arch)))
    assert all(t.is_meta for t in adamw.tree_leaves(got))
    assert torch_leaves(got) == want
    n = sum(t.numel() for t in adamw.tree_leaves(got))
    assert n == sum(int(np.prod(s)) for s, _ in want.values())
    if arch == "deepseek-v2-236b":
        assert n == 239_375_569_920
    if arch == "llama3.2-3b":
        assert n == 3_212_749_824


@pytest.mark.parametrize("arch, shape", treg.runnable_cells())
def test_input_specs_and_model_flops_equal_jax(arch, shape, jdry):
    """``input_specs`` (decode caches included) and ``model_flops`` of every
    cell at full size."""
    tc, jc = treg.get_config(arch), jreg.get_config(arch)
    sp = tshapes.SHAPES[shape]
    got = torch_leaves(treg.input_specs(tc, sp))
    assert got == jax_leaves(jreg.input_specs(jc, jshapes.SHAPES[shape]))
    n = sum(t.numel() for t in adamw.tree_leaves(treg.abstract_params(tc)))
    assert dryrun.model_flops(tc, n, sp) == jdry.model_flops(jc, n, jshapes.SHAPES[shape])


def test_model_flops_moe_vs_dense():
    """``tests/test_dryrun_unit.py::test_model_flops_moe_vs_dense``, ported."""
    dense_cfg = treg.get_config("llama3.2-3b")
    moe_cfg = treg.get_config("deepseek-moe-16b")
    sp = tshapes.SHAPES["train_4k"]
    f_dense = dryrun.model_flops(dense_cfg, 3_200_000_000, sp)
    assert abs(f_dense - 6 * 3.2e9 * 256 * 4096) / f_dense < 1e-6
    n_total = 16_000_000_000
    f_moe = dryrun.model_flops(moe_cfg, n_total, sp)
    assert f_moe < 6 * n_total * 256 * 4096


def test_variants_equal_jax(jdry):
    assert dryrun.VARIANTS == jdry.VARIANTS


def _real(tree, gen):
    """The meta tree with CPU tensors of the same shapes, dtypes and
    ``requires_grad`` (normal floats, zero integers)."""
    if isinstance(tree, torch.Tensor):
        t = (torch.randn(tree.shape, generator=gen).to(tree.dtype) if tree.dtype.is_floating_point
             else torch.zeros(tree.shape, dtype=tree.dtype))
        return t.requires_grad_(tree.requires_grad)
    if isinstance(tree, dict):
        return {k: _real(v, gen) for k, v in tree.items()}
    if hasattr(tree, "_fields"):
        return type(tree)(*(_real(v, gen) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_real(v, gen) for v in tree)
    return tree


SMOKE_STEPS = {"train": ShapeSpec("train", 32, 2, "train"),
               "prefill": ShapeSpec("prefill", 32, 2, "prefill"),
               "decode": ShapeSpec("decode", 256, 2, "decode")}  # two 128-token KV blocks


#: (arch, step, variant): every id's three steps, and its decode step with
#: the anchored cache (B1; K6 in the dense families).
COUNT_CASES = ([(a, k, "baseline") for a in treg.ARCH_IDS for k in SMOKE_STEPS]
               + [(a, "decode", "B1") for a in treg.ARCH_IDS])


@pytest.mark.parametrize("arch, kind, variant", COUNT_CASES)
def test_meta_counts_equal_cpu_counts(arch, kind, variant):
    """A SMOKE step's FLOPs, bytes, kernel calls and memory analysis on
    meta equal the same step's on CPU tensors (the plain versions of K6,
    K7 and K7b hidden from the counter, their formulas counted)."""
    cfg, fn, args, n = dryrun.build_cell(arch, SMOKE_STEPS[kind], smoke=True, variant=variant)
    c_meta, mem_meta = dryrun.memory(fn, args)
    cfg, fn, args, n = dryrun.build_cell(arch, SMOKE_STEPS[kind], smoke=True, variant=variant)
    c_cpu, mem_cpu = dryrun.memory(fn, _real(args, torch.Generator().manual_seed(0)))
    assert c_meta.flops == c_cpu.flops and c_meta.bytes == c_cpu.bytes
    assert c_meta.flops_tensor_core == c_cpu.flops_tensor_core
    assert c_meta.kernels == c_cpu.kernels
    assert mem_meta == mem_cpu
    if variant == "B1" and cfg.family in ("dense", "vlm", "moe"):
        assert c_meta.kernels["rcll_kv_decode"]["calls"] == cfg.n_layers


@pytest.mark.parametrize("arch", ["llama3.2-3b", "deepseek-moe-16b", "zamba2-1.2b"])
def test_aten_flops_are_flop_counter_modes(arch):
    """The counter's aten FLOPs equal ``FlopCounterMode``'s total over the
    same SMOKE train step on CPU tensors (the kernels' plain versions are
    hidden from both)."""
    cfg, fn, args, n = dryrun.build_cell(arch, SMOKE_STEPS["train"], smoke=True)
    args = _real(args, torch.Generator().manual_seed(0))
    with FlopCounterMode(display=False) as fm, cost.CostCounter() as c:
        fn(*args, c)
    assert c.aten_flops == fm.get_total_flops() > 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal, lq, lk", [(True, 5, 5), (True, 3, 7), (True, 7, 3),
                                             (False, 4, 6)])
def test_attention_meta_paths_and_counts(causal, lq, lk, dtype):
    """K7's and K7b's meta paths give empty outputs of the right shapes and
    dtypes, and each call counts 4 Dh (K7) or 10 Dh (K7b) FLOPs a visible
    pair and its bytes, on meta as on the CPU."""
    b, h, hkv, dh = 2, 4, 2, 16
    pairs = sum(min(max(i + lk - lq + 1, 0), lk) for i in range(lq)) if causal else lq * lk
    assert cost.visible_pairs(lq, lk, causal) == pairs
    args = k7.random_bwd_inputs(3, b, h, hkv, lq, lk, dh, dtype, causal=causal)
    counts = {}
    for dev in ("meta", "cpu"):
        a = tuple(t.to(dev) for t in args)
        with cost.CostCounter() as c:
            out = k7.flash_attention(*a[:3], causal=causal)
            grads = k7.flash_attention_bwd(*a, causal=causal)
        assert out.shape == (b, h, lq, dh) and out.dtype == torch.float32
        for g, t in zip(grads, a[:3]):
            assert g.shape == t.shape and g.dtype == torch.float32
        assert c.aten_flops == 0 and c.aten_bytes == 0
        counts[dev] = c.kernels
    assert counts["meta"] == counts["cpu"]
    es = args[0].element_size()
    qkv = (b * h * lq + 2 * b * hkv * lk) * dh
    assert counts["cpu"]["flash_attention"] == {
        "calls": 1, "flops": 4 * dh * b * h * pairs, "bytes": qkv * es + b * h * lq * dh * 4}
    assert counts["cpu"]["flash_attention_bwd"] == {
        "calls": 1, "flops": 10 * dh * b * h * pairs,
        "bytes": qkv * es + (2 * b * h * lq * dh + 2 * b * h * lq + qkv) * 4}  # O, dO; lse, D


def test_kv_decode_meta_path_and_count():
    """K6's meta path and its count: every key of the cache's capacity,
    4 Dh to dequantize and 4 Dh for each query head."""
    b, h, hkv, dh, nblk, blk = 2, 6, 2, 16, 3, 32
    args = k6.random_inputs(4, b, h, hkv, dh, nblk, blk, torch.int8, [40, 3])
    counts = {}
    for dev in ("meta", "cpu"):
        a = tuple(t.to(dev) for t in args)
        with cost.CostCounter() as c:
            out, m, den = k6.rcll_kv_decode(*a, return_stats=True)
        assert out.shape == (b, h, dh) and m.shape == den.shape == (b, h)
        assert out.dtype == m.dtype == torch.float32
        counts[dev] = c.kernels
    assert counts["meta"] == counts["cpu"]
    keys = b * hkv * nblk * blk
    assert counts["cpu"]["rcll_kv_decode"] == {
        "calls": 1, "flops": keys * dh * (4 + 4 * (h // hkv)),
        "bytes": b * hkv * nblk * (2 * blk * dh + 4 * dh * 4) + b * h * dh * 4
        + b * h * (dh + 2) * 4 + b * 4}


@pytest.mark.parametrize("arch, shape", treg.runnable_cells(smoke=True))
def test_run_cell_smoke(arch, shape, tmp_path):
    rec = dryrun.run_cell(arch, shape, smoke=True, out_dir=str(tmp_path))
    assert rec["ok"], rec.get("traceback")
    with open(tmp_path / f"{arch}__{shape}__1.json") as f:
        saved = json.load(f)
    assert saved["ok"] and saved["mesh"] == "1" and saved["n_chips"] == 1
    for key in ("n_params", "memory", "flops_per_device", "bytes_per_device", "collectives",
                "model_flops_global", "t_compute", "t_memory", "t_collective",
                "useful_flops_frac", "bottleneck", "probe", "t_total_s"):
        assert key in saved, key
    assert saved["t_collective"] == 0.0 and saved["collectives"]["total"] == 0
    mem = saved["memory"]
    if saved["kind"] == "train":
        n_bytes = 4 * saved["n_params"]  # fp32 masters; the moments the same
        batch = 2 * 4 * tshapes.SHAPES[shape].global_batch * tshapes.SHAPES[shape].seq_len
        assert mem["alias_size_in_bytes"] == 3 * n_bytes  # updated in place
        assert mem["output_size_in_bytes"] == 3 * n_bytes + 4 + 4  # + the step, the loss
        assert mem["argument_size_in_bytes"] >= 3 * n_bytes + 4 + batch
        assert mem["temp_size_in_bytes"] > 0


@pytest.mark.parametrize("variant", list(dryrun.VARIANTS))
def test_run_cell_variants(variant):
    """Every perf variant's train and decode cells run: A2 casts the fp32
    matrices before use (the FLOPs unchanged), B1 and B2 read the anchored
    cache (K6), B2 holds its serving parameters in bf16 (2 bytes fewer
    each)."""
    def run(shape, v):
        rec = dryrun.run_cell("llama3.2-3b", shape, smoke=True, variant=v)
        assert rec["ok"], rec.get("traceback")
        return rec

    train, train_base = run("train_4k", variant), run("train_4k", "baseline")
    assert train["flops_per_device"] == train_base["flops_per_device"]
    anchored = variant in ("B1", "B2")
    dec, dec_ref = run("decode_32k", variant), run("decode_32k", "B1" if anchored else "baseline")
    assert ("rcll_kv_decode" in dec["kernels"]) == anchored
    want = dec_ref["memory"]["argument_size_in_bytes"]
    if variant == "B2":
        want -= 2 * dec["n_params"]
    assert dec["memory"]["argument_size_in_bytes"] == want


def test_waits_for_sharding(monkeypatch):
    with pytest.raises(NotImplementedError):
        dryrun.logits_sharding(None, treg.get_config("llama3.2-3b"), 8)
    with pytest.raises(NotImplementedError):
        dryrun.run_cell("llama3.2-3b", "train_4k", multi_pod=True, smoke=True)
    for flag in ("--multi-pod", "--both"):
        monkeypatch.setattr("sys.argv", ["dryrun", "--all", "--smoke", flag])
        with pytest.raises(NotImplementedError):
            dryrun.main()


def test_cli_writes_a_record(monkeypatch, tmp_path):
    monkeypatch.setattr("sys.argv", ["dryrun", "--arch", "mamba2-130m", "--shape", "long_500k",
                                     "--smoke", "--out", str(tmp_path)])
    with pytest.raises(SystemExit) as e:
        dryrun.main()
    assert e.value.code == 0
    assert json.loads((tmp_path / "mamba2-130m__long_500k__1.json").read_text())["ok"]


# --------------------------------------------------------------------------
# the MoE expert counts: a scatter-add, bit-equal to torch.bincount
# --------------------------------------------------------------------------
def _bincount(idx, n_experts):
    return torch.bincount(idx.reshape(-1).long(), minlength=n_experts)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_expert_counts_equal_bincount(seed, monkeypatch):
    """The counts, and the MoE block's output, drop fraction and aux loss
    with them, are bit-equal to ``torch.bincount``'s (as before)."""
    gen = torch.Generator().manual_seed(seed)
    idx = torch.randint(0, 16, (300, 6), generator=gen)
    assert torch.equal(tmoe.expert_counts(idx, 16), _bincount(idx, 16))
    assert tmoe.expert_counts(idx.to("meta"), 16).shape == (16,)
    cfg = treg.get_config("deepseek-moe-16b", smoke=True)
    p = tmoe.init_moe(gen, cfg.d_model, cfg.d_expert, cfg.n_routed, cfg.n_shared)
    x = torch.randn(2, 48, cfg.d_model, generator=gen).to(torch.bfloat16)
    kw = dict(top_k=cfg.top_k, n_routed=cfg.n_routed, capacity_factor=1.0)
    out, m = tmoe.moe_block(p, x, **kw)
    monkeypatch.setattr(tmoe, "expert_counts", _bincount)
    out_b, m_b = tmoe.moe_block(p, x, **kw)
    assert torch.equal(out, out_b)
    assert torch.equal(m["aux_loss"], m_b["aux_loss"])
    assert torch.equal(m["drop_frac"], m_b["drop_frac"])
