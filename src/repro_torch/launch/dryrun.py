"""Dry run without the card: every (architecture x input shape) cell of
the registry run once on the meta device (shapes and dtypes, nothing
allocated), on one card or on JAX's production meshes, its cost read by
the port's counter, and an H100 roofline of it.

Port of ``repro.launch.dryrun``. JAX AOT-compiles each cell on a fake
16x16 or 2x16x16 TPU mesh and reads XLA's cost and memory analysis and
the HLO's collectives; the port runs the cell's step eagerly on meta
tensors under ``kernels.cost.CostCounter`` and measures its own way:

  flops    ``torch.utils.flop_counter.FlopCounterMode`` over the step's
           aten ops, plus each hand-written kernel's analytic count (K6,
           K7 and K7b launch through ctypes, which no dispatch mode
           sees): K7 4 Dh FLOPs a visible (query, key) pair, K7b 10 Dh,
           K6 every key of the cache's capacity. A train step is
           ``launch.train.train_step``: the family's ``loss_fn``, its
           backward (each layer body recomputed under the config's
           ``remat="full"``) and the in-place AdamW update.
  bytes    each aten op's inputs and outputs (views and allocations
           free, a broadcast dimension once) and each kernel's inputs read
           once and outputs written once: the eager port's own traffic,
           with no fusion (XLA's count is of its fused HLO).
  memory   argument: the parameters, the optimizer state (moments and
           step) and the batch, or the tokens and the cache, from the
           meta tensors' bytes; output: what the step returns (a train
           step its parameters, optimizer state and loss, a serving step
           its logits and cache); alias: the part of the output that is
           an input's storage (the port updates parameters, moments and a
           decode cache in place); temp: for a train step, the bytes the
           backward holds at the end of the forward (every storage the
           forward made that is still alive: autograd's saved tensors,
           the K7 outputs its op keeps, and each checkpointed layer's
           inputs, which the checkpoint keeps outside any saved-tensor
           hook); for prefill and decode, the most bytes the
           step's own storages held at once, its outputs left out.

probe is "meta": the Python layer loop runs every layer, so one eager
run counts the whole step (JAX's "unrolled" probe and
``models/scan_config.py`` exist to see through ``lax.scan``).

Meshes. With no mesh flag a cell runs on one card, mesh "1":
``t_collective`` is 0 and no collective runs. ``--multi-pod`` and
``--both`` run it on JAX's meshes, "16x16" and "2x16x16", over a fake
process group of 256 or 512 ranks made for the cell and destroyed after
it (``launch.mesh.fake_production_mesh``; this process is rank 0 and
its tensors are rank 0's meta shards, ``shardings.lay_out``): the
parameters on ``param_shardings`` (FSDP over "data" from
:data:`FSDP_THRESHOLD` parameters, not for B2's serving ones,
:func:`fsdp_for`), the moments, batch, tokens and caches on JAX's
layouts, the logits and a prefill's cache returned on
:func:`logits_sharding` and ``cache_shardings``. The counts are per
device (rank 0's work, ``CostCounter`` on DTensors), and each functional
collective is counted by JAX's name with its result's bytes;
``t_collective`` is those bytes over :data:`NET_BW`.

These per-device FLOPs, bytes and collectives are the PORT's
partitioning, not GSPMD's (ROADMAP Queue 3): the row-parallel products
gather their input and split over DP only, the products of a whole
weight (``partitioning.replica_product``: MLA's ``wq_a``/``wkv_a``, vlm's
``w_patch``, an unembedding "model" does not divide) gather it on every
rank, MoE routing runs whole on every rank, mamba2's conv, SSD and decode
recurrence run whole over "model" (the state gathered), and a head count
"model" does not divide is gathered before it is split. So
``useful_flops_frac`` reads lower than JAX's would. Where DTensor (torch
2.11, 2.13) has no rule, or plans for minutes on 2 x 16 x 16, the models
run each rank's shard explicitly: the caches' per-row writes
(``partitioning.write_positions``), dense and anchored decode attention
(``attention.sharded_decode_sdpa``, ``sharded_anchored_attention``: K6 on
each rank's blocks), MLA's absorbed decode (``mla._sharded_absorbed``),
decode's cross-attention and positions (``attention.plain_attend``,
``encdec.decode_step``), mamba2's decode (``mamba2.mamba2_decode``).

Usage (no card needed; the meta device runs on the CPU):
  python -m repro_torch.launch.dryrun --arch llama3.2-3b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--smoke] [--multi-pod|--both]
  python -m repro_torch.launch.dryrun --all --both --skip-done --out experiments/dryrun

Each cell writes <out>/<arch>__<shape>__<mesh>.json (mesh "1", "16x16"
or "2x16x16"; a variant adds ``__<variant>``) with JAX's fields (and
``kernels``, ``flops_tensor_core``, ``flops_other``).
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time
import traceback

import torch

from repro_torch.configs.shapes import SHAPES, ShapeSpec
from repro_torch.kernels.cost import COLLECTIVES, CostCounter
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import shardings as sh
from repro_torch.launch.train import mesh_scope, train_step
from repro_torch.models import partitioning as pt
from repro_torch.models import registry
from repro_torch.models.partitioning import P, NamedSharding
from repro_torch.optim import adamw

# ---- H100 SXM constants (roofline), NVIDIA's data sheet --------------------
PEAK_FLOPS = 989e12  # bf16 on the tensor cores, dense, H100 SXM
PEAK_FLOPS_FP32 = 67e12  # fp32 outside the tensor cores, H100 SXM
HBM_BW = 3.35e12  # HBM3 bytes/s, H100 SXM

# ---- the network between H100s on JAX's production meshes ----------------
# Every axis of a 16 x 16 (or 2 x 16 x 16) mesh of 8-card nodes leaves the
# node, so a collective runs over the InfiniBand fabric: one 400 Gb/s NDR
# port (ConnectX-7) per H100, NVIDIA's DGX H100 data sheet.
NET_BW = 50e9  # bytes/s per card

MESH = "1"  # one card, no mesh

FSDP_THRESHOLD = 1_000_000_000  # params >= 1B: shard params over "data"


def model_flops(cfg, n_params: int, shape) -> float:
    """MODEL_FLOPS = 6ND train / 2ND per generated token (active params)."""
    if cfg.n_routed:
        expert_p = 3 * cfg.d_model * cfg.d_expert * cfg.n_layers
        inactive = (cfg.n_routed - cfg.top_k) * expert_p
        n_active = n_params - inactive
    else:
        n_active = n_params
    tokens = shape.global_batch * (
        shape.seq_len if shape.kind != "decode" else 1)
    return (6.0 if shape.kind == "train" else 2.0) * n_active * tokens


def logits_sharding(mesh, cfg, batch: int):
    """(B, L, V) sharding honoring divisibility on both axes."""
    dp = sh.dp_axes(mesh)
    b_ax = dp if batch % sh.dp_size(mesh) == 0 else None
    v_ax = "model" if cfg.vocab % pt.axis_sizes(mesh)["model"] == 0 else None
    return NamedSharding(mesh, P(b_ax, None, v_ax))


# Perf variants (EXPERIMENTS.md section Perf). Each entry: (config
# overrides, step options). "opt" is the beyond-paper combination.
VARIANTS = {
    "baseline": ({}, {}),
    "A1": ({"attn_kv_hoist": True}, {}),
    "A2": ({}, {"cast_bf16": True}),
    "A3": ({"moe_cap_shard": True}, {}),
    "A12": ({"attn_kv_hoist": True}, {"cast_bf16": True}),
    "A123": ({"attn_kv_hoist": True, "moe_cap_shard": True},
             {"cast_bf16": True}),
    "B1": ({"kv_mode": "anchored"}, {}),
    "B2": ({"kv_mode": "anchored"}, {"serve_bf16": True}),
    "C1": ({"ssd_compute": "bf16"}, {}),
    "opt": ({"attn_kv_hoist": True, "moe_cap_shard": True,
             "ssd_compute": "bf16"}, {"cast_bf16": True}),
}


def _own(t: torch.Tensor) -> torch.Tensor:
    """This rank's tensor: a DTensor's local shard, else ``t``."""
    return t.to_local() if pt.is_dtensor(t) else t


def tree_bytes(tree) -> int:
    """Bytes of every tensor in a nested dict / NamedTuple / tuple (of a
    DTensor, this rank's shard)."""
    if isinstance(tree, torch.Tensor):
        tree = _own(tree)
        return tree.numel() * tree.element_size()
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    if isinstance(tree, (tuple, list)):
        return sum(tree_bytes(v) for v in tree)
    return 0


def _storages(tree) -> set:
    if isinstance(tree, torch.Tensor):
        return {_own(tree).untyped_storage()._cdata}
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (tuple, list)):
        return set().union(*(_storages(v) for v in tree)) if tree else set()
    return set()


def _aliased_bytes(out, inputs) -> int:
    """Bytes of the tensors of ``out`` that live in a storage of ``inputs``."""
    if isinstance(out, torch.Tensor):
        return tree_bytes(out) if _own(out).untyped_storage()._cdata in inputs else 0
    if isinstance(out, dict):
        out = list(out.values())
    if isinstance(out, (tuple, list)):
        return sum(_aliased_bytes(v, inputs) for v in out)
    return 0


class _CastBF16:
    """Perf A2: the family's ``loss_fn`` on bf16 copies of the fp32 matrices
    (ndim >= 2), cast before use; the gradients reach the fp32 masters."""

    def __init__(self, mod):
        self.mod = mod

    def loss_fn(self, params, batch, cfg):
        pb = adamw.tree_map(lambda x: x.to(torch.bfloat16)
                            if x.dtype == torch.float32 and x.ndim >= 2 else x, params)
        return self.mod.loss_fn(pb, batch, cfg)


def fsdp_for(n_params: int, kind: str, step_opts: dict) -> bool:
    """JAX's FSDP decision: parameters over "data" from
    :data:`FSDP_THRESHOLD` of them up, except B2's serving parameters
    (``serve_bf16``: TP only, no gathers on the decode path)."""
    return (n_params >= FSDP_THRESHOLD
            and not (step_opts.get("serve_bf16") and kind != "train"))


def cell_params(arch: str, shape: str | ShapeSpec, *, smoke: bool, variant: str = "baseline"):
    """(cfg, shape, step options, meta params, n_params, fsdp) of a cell:
    the variant's config overrides, B2's bf16 serving parameters and JAX's
    FSDP decision (:func:`fsdp_for`)."""
    cfg = registry.get_config(arch, smoke=smoke)
    overrides, step_opts = VARIANTS[variant]
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    shape = SHAPES[shape] if isinstance(shape, str) else shape
    params = registry.abstract_params(cfg)
    if step_opts.get("serve_bf16") and shape.kind != "train":
        # Perf B2: serving params live in bf16 (a serving system never
        # holds fp32 masters)
        params = adamw.tree_map(lambda x: torch.empty(
            x.shape, dtype=torch.bfloat16 if x.dtype == torch.float32 else x.dtype,
            device="meta"), params)
    n_params = sum(t.numel() for t in adamw.tree_leaves(params))
    return cfg, shape, step_opts, params, n_params, fsdp_for(n_params, shape.kind, step_opts)


def build_cell(arch: str, shape: str | ShapeSpec, *, smoke: bool, variant: str = "baseline",
               mesh=None):
    """Returns (cfg, fn, in_args, n_params): ``fn(*in_args, counter)`` runs
    the cell's step once on meta tensors (``counter``, a
    :class:`CostCounter` the caller has open, is read after the forward of
    a train step). ``shape`` is a name of ``SHAPES`` or a ``ShapeSpec``.
    Without ``mesh``, one card: plain tensors. With a ``DeviceMesh``
    (:func:`launch.mesh.fake_mesh`), JAX's layouts: the parameters on
    ``param_shardings`` (FSDP as :func:`fsdp_for` decides), the moments on
    ``opt_shardings``, the batch and tokens on ``batch_shardings``, a decode
    cache on ``cache_shardings``, as DTensors of this rank's meta shards
    (``shardings.lay_out``); the step runs under ``train.mesh_scope`` and
    returns its logits on :func:`logits_sharding` and a prefill's cache on
    ``cache_shardings``, as JAX's ``out_shardings`` ask."""
    cfg, shape, step_opts, params, n_params, fsdp = cell_params(arch, shape, smoke=smoke,
                                                                 variant=variant)
    mod = registry.get_module(cfg)
    specs = registry.input_specs(cfg, shape)
    p_sh = None
    if mesh is not None:
        p_sh = sh.param_shardings(mesh, params, fsdp=fsdp)

    def laid(tree, shardings):
        return tree if mesh is None else sh.lay_out(tree, shardings)

    def out_laid(out):
        """The step's (logits, cache) on JAX's out_shardings: the cache on
        ``cache_shardings`` of its own shapes (a decode step's is its
        input's, updated in place)."""
        if mesh is None:
            return out
        lg, cache = out
        lg = sh.constrain(lg, logits_sharding(mesh, cfg, shape.global_batch))
        return lg, sh.constrain(cache, sh.cache_shardings(mesh, cache, shape.global_batch,
                                                           shape.seq_len))

    if shape.kind == "train":
        opt_state = adamw.init(params)
        if mesh is not None:
            opt_state = opt_state._replace(mu=laid(opt_state.mu, p_sh), nu=laid(opt_state.nu, p_sh))
            params = laid(params, p_sh)
        for p in adamw.tree_leaves(params):
            p.requires_grad_(True)
        batch = specs["batch"]
        if mesh is not None:
            batch = laid(batch, sh.batch_shardings(mesh, batch))
        ocfg = adamw.OptConfig()
        step_mod = _CastBF16(mod) if step_opts.get("cast_bf16") else mod

        def fn(params, opt_state, batch, counter):
            held = {}

            def mark(part):
                if part == "forward":
                    held["temp"] = counter.held_bytes()

            with mesh_scope(mesh):
                params, opt_state, m = train_step(step_mod, cfg, ocfg, params, opt_state, batch,
                                                  mark=mark)
            return (params, opt_state, m["loss"]), held["temp"]

        return cfg, fn, (params, opt_state, batch), n_params
    params = laid(params, p_sh)
    if shape.kind == "prefill":
        tok = specs["tokens"]
        extra = {k: v for k, v in specs.items() if k != "tokens"}
        if mesh is not None:
            tok = laid(tok, sh.batch_shardings(mesh, tok))
            extra = laid(extra, sh.batch_shardings(mesh, extra))

        def fn(params, tokens, extra_in, counter):
            with torch.no_grad(), mesh_scope(mesh):
                return out_laid(mod.prefill(params, tokens, cfg, shape.seq_len,
                                            **extra_in)), None

        return cfg, fn, (params, tok, extra), n_params

    tok, cache = specs["tokens"], specs["cache"]
    if mesh is not None:
        tok = laid(tok, sh.batch_shardings(mesh, tok))
        cache = laid(cache, sh.cache_shardings(mesh, cache, shape.global_batch, shape.seq_len))

    def fn(params, tokens, cache, counter):  # decode
        with torch.no_grad(), mesh_scope(mesh):
            return out_laid(mod.decode_step(params, tokens, cache, cfg)), None

    return cfg, fn, (params, tok, cache), n_params


def memory(fn, in_args) -> dict:
    """Run ``fn`` (a :func:`build_cell` step) once on its meta inputs under
    a fresh :class:`CostCounter`; returns the counter and the memory
    analysis (the module's docstring says what each term is; on a mesh,
    this rank's shards)."""
    with CostCounter() as counter:
        out, temp = fn(*in_args, counter)
    out_bytes = tree_bytes(out)
    alias = _aliased_bytes(out, _storages(in_args))
    if temp is None:  # prefill, decode: the peak, less the outputs the step made
        temp = max(counter.peak_made_bytes - (out_bytes - alias), 0)
    mem = {"argument_size_in_bytes": tree_bytes(in_args),
           "output_size_in_bytes": out_bytes,
           "temp_size_in_bytes": temp,
           "alias_size_in_bytes": alias}
    return counter, mem


def mesh_name(multi_pod: bool | None) -> str:
    """The record's mesh: "1" (one card, ``None``), "16x16" or "2x16x16"."""
    if multi_pod is None:
        return MESH
    return "2x16x16" if multi_pod else "16x16"


def record_path(out_dir: str, arch: str, shape: str, mesh: str,
                variant: str = "baseline") -> str:
    suffix = "" if variant == "baseline" else f"__{variant}"
    return os.path.join(out_dir, f"{arch}__{shape}__{mesh}{suffix}".replace("/", "_") + ".json")


def run_cell(arch: str, shape_name: str | ShapeSpec, *, multi_pod: bool | None = None,
             smoke: bool = False, out_dir: str | None = None,
             variant: str = "baseline") -> dict:
    """One cell: build it, run its step on meta under the counter, and
    write (to ``out_dir``, when given) and return its record. ``multi_pod``
    None runs it on one card (mesh "1"); False and True on JAX's 16x16 and
    2x16x16 meshes, over a fake process group made for the cell and
    destroyed after it (:func:`launch.mesh.fake_production_mesh`)."""
    shape = SHAPES[shape_name] if isinstance(shape_name, str) else shape_name
    name = mesh_name(multi_pod)
    rec = {"arch": arch, "shape": shape.name, "mesh": name, "kind": shape.kind,
           "variant": variant, "ok": False}
    t0 = time.time()
    try:
        scope = (contextlib.nullcontext() if multi_pod is None
                 else mesh_lib.fake_production_mesh(multi_pod))
        with scope as mesh:
            cfg, fn, in_args, n_params = build_cell(arch, shape, smoke=smoke, variant=variant,
                                                    mesh=mesh)
            rec["n_params"] = n_params
            rec["t_lower_s"] = round(time.time() - t0, 2)  # building the meta inputs
            t1 = time.time()
            counter, mem = memory(fn, in_args)
            rec["t_compile_s"] = round(time.time() - t1, 2)  # the meta run
            n_chips = 1 if mesh is None else mesh.size()
            del fn, in_args
        print(f"[{arch} {shape.name} {name}] "
              f"mem={mem['temp_size_in_bytes']/2**30:.2f}GiB tmp "
              f"args={mem['argument_size_in_bytes']/2**30:.2f}GiB")
        flops, byts = counter.flops, counter.bytes
        coll = counter.collectives
        rec.update({"raw_flops_per_device": flops, "raw_bytes_per_device": byts,
                    "raw_collectives": coll, "probe": "meta"})
        mf = model_flops(cfg, n_params, shape)
        rec.update({
            "ok": True,
            "memory": mem,
            "flops_per_device": flops,
            "bytes_per_device": byts,
            "collectives": coll,
            "n_chips": n_chips,
            "model_flops_global": mf,
            "flops_tensor_core": counter.flops_tensor_core,
            "flops_other": counter.flops_other,
            "kernels": counter.kernels,
            "t_compute": (counter.flops_tensor_core / PEAK_FLOPS
                          + counter.flops_other / PEAK_FLOPS_FP32),
            "t_memory": byts / HBM_BW,
            "t_collective": coll["total"] / NET_BW,
            "useful_flops_frac": (mf / n_chips) / flops if flops else None,
        })
        terms = {"compute": rec["t_compute"], "memory": rec["t_memory"],
                 "collective": rec["t_collective"]}
        rec["bottleneck"] = max(terms, key=terms.get)
        print(f"  flops/dev={flops:.3e} bytes/dev={byts:.3e} "
              f"coll={coll['total']:.3e}B -> {rec['bottleneck']}-bound "
              f"(c={rec['t_compute']*1e3:.1f}ms m={rec['t_memory']*1e3:.1f}ms "
              f"x={rec['t_collective']*1e3:.1f}ms) probe=meta")
    except Exception as e:  # a cell's failure is its record; the others go on
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()
        print(f"[{arch} {shape.name} {name}] FAIL {rec['error']}")
    rec["t_total_s"] = round(time.time() - t0, 2)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        with open(record_path(out_dir, arch, shape.name, name, variant), "w") as f:
            json.dump(rec, f, indent=1)
    return rec


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=registry.ARCH_IDS)
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both", action="store_true",
                    help="run single-pod AND multi-pod meshes")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--out", default="experiments/dryrun")
    ap.add_argument("--skip-done", action="store_true")
    ap.add_argument("--variant", default="baseline",
                    choices=list(VARIANTS))
    args = ap.parse_args()
    if not args.all and not (args.arch and args.shape):
        ap.error("--arch and --shape, or --all")

    cells = (registry.runnable_cells(smoke=args.smoke) if args.all
             else [(args.arch, args.shape)])
    # no flag: one card (mesh "1"); --multi-pod, --both: JAX's meshes
    meshes = [False, True] if args.both else [True] if args.multi_pod else [None]
    n_ok = n_fail = 0
    for arch, shape_name in cells:
        for mp in meshes:
            if args.skip_done and args.out:
                p = record_path(args.out, arch, shape_name, mesh_name(mp), args.variant)
                if os.path.exists(p):
                    with open(p) as f:
                        if json.load(f).get("ok"):
                            n_ok += 1
                            continue
            rec = run_cell(arch, shape_name, multi_pod=mp, smoke=args.smoke, out_dir=args.out,
                           variant=args.variant)
            n_ok += rec["ok"]
            n_fail += not rec["ok"]
    left = torch.distributed.is_initialized()  # a fake mesh's group outliving its cell
    print(f"\ndry-run: {n_ok} ok, {n_fail} failed"
          + ("; a process group is left initialized" if left else ""))
    raise SystemExit(1 if n_fail or left else 0)


if __name__ == "__main__":
    main()
