"""Dry run on one card, without the card: every (architecture x input
shape) cell of the registry run once on the meta device (shapes and
dtypes, nothing allocated), its cost read by the port's counter, and an
H100 roofline of it.

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
``models/scan_config.py`` exist to see through ``lax.scan``). The mesh is
"1", one card: ``t_collective`` is 0 and no collective runs. JAX's
production meshes, its FSDP split and its logits sharding wait for the
sharding slice (``--multi-pod``, ``--both`` and :func:`logits_sharding`
raise).

Usage (no card needed; the meta device runs on the CPU):
  python -m repro_torch.launch.dryrun --arch llama3.2-3b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--smoke]
  python -m repro_torch.launch.dryrun --all --out experiments/dryrun

Each cell writes <out>/<arch>__<shape>__1.json with JAX's fields (and
``kernels``, ``flops_tensor_core``, ``flops_other``).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback

import torch

from repro_torch.configs.shapes import SHAPES, ShapeSpec
from repro_torch.kernels.cost import CostCounter
from repro_torch.launch.train import train_step
from repro_torch.models import registry
from repro_torch.optim import adamw

# ---- H100 SXM constants (roofline), NVIDIA's data sheet --------------------
PEAK_FLOPS = 989e12  # bf16 on the tensor cores, dense, H100 SXM
PEAK_FLOPS_FP32 = 67e12  # fp32 outside the tensor cores, H100 SXM
HBM_BW = 3.35e12  # HBM3 bytes/s, H100 SXM

MESH = "1"  # one card

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute")


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
    """JAX's (B, L, V) logits sharding; waits for the sharding slice."""
    raise NotImplementedError("logits_sharding: sharding is not ported; one card only")


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


def tree_bytes(tree) -> int:
    """Bytes of every tensor in a nested dict / NamedTuple / tuple."""
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    if isinstance(tree, (tuple, list)):
        return sum(tree_bytes(v) for v in tree)
    return 0


def _storages(tree) -> set:
    if isinstance(tree, torch.Tensor):
        return {tree.untyped_storage()._cdata}
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (tuple, list)):
        return set().union(*(_storages(v) for v in tree)) if tree else set()
    return set()


def _aliased_bytes(out, inputs) -> int:
    """Bytes of the tensors of ``out`` that live in a storage of ``inputs``."""
    if isinstance(out, torch.Tensor):
        return tree_bytes(out) if out.untyped_storage()._cdata in inputs else 0
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


def build_cell(arch: str, shape: str | ShapeSpec, *, smoke: bool, variant: str = "baseline"):
    """Returns (cfg, fn, in_args, n_params): ``fn(*in_args, counter)`` runs
    the cell's step once on meta tensors (``counter``, a
    :class:`CostCounter` the caller has open, is read after the forward of
    a train step). ``shape`` is a name of ``SHAPES`` or a ``ShapeSpec``.
    One card: no shardings (JAX's take a mesh and split the parameters
    over "data" from 1e9 of them, FSDP)."""
    cfg = registry.get_config(arch, smoke=smoke)
    overrides, step_opts = VARIANTS[variant]
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    shape = SHAPES[shape] if isinstance(shape, str) else shape
    mod = registry.get_module(cfg)
    specs = registry.input_specs(cfg, shape)
    params = registry.abstract_params(cfg)
    if step_opts.get("serve_bf16") and shape.kind != "train":
        # Perf B2: serving params live in bf16 (a serving system never
        # holds fp32 masters)
        params = adamw.tree_map(lambda x: torch.empty(
            x.shape, dtype=torch.bfloat16 if x.dtype == torch.float32 else x.dtype,
            device="meta"), params)
    n_params = sum(t.numel() for t in adamw.tree_leaves(params))

    if shape.kind == "train":
        for p in adamw.tree_leaves(params):
            p.requires_grad_(True)
        opt_state = adamw.init(params)
        ocfg = adamw.OptConfig()
        step_mod = _CastBF16(mod) if step_opts.get("cast_bf16") else mod

        def fn(params, opt_state, batch, counter):
            held = {}

            def mark(part):
                if part == "forward":
                    held["temp"] = counter.held_bytes()

            params, opt_state, m = train_step(step_mod, cfg, ocfg, params, opt_state, batch,
                                              mark=mark)
            return (params, opt_state, m["loss"]), held["temp"]

        return cfg, fn, (params, opt_state, specs["batch"]), n_params
    if shape.kind == "prefill":
        tok = specs["tokens"]
        extra = {k: v for k, v in specs.items() if k != "tokens"}

        def fn(params, tokens, extra_in, counter):
            with torch.no_grad():
                return mod.prefill(params, tokens, cfg, shape.seq_len, **extra_in), None

        return cfg, fn, (params, tok, extra), n_params

    def fn(params, tokens, cache, counter):  # decode
        with torch.no_grad():
            return mod.decode_step(params, tokens, cache, cfg), None

    return cfg, fn, (params, specs["tokens"], specs["cache"]), n_params


def memory(fn, in_args) -> dict:
    """Run ``fn`` (a :func:`build_cell` step) once on its meta inputs under
    a fresh :class:`CostCounter`; returns the counter and the memory
    analysis (the module's docstring says what each term is)."""
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


def run_cell(arch: str, shape_name: str | ShapeSpec, *, multi_pod: bool = False,
             smoke: bool = False, out_dir: str | None = None,
             variant: str = "baseline") -> dict:
    """One cell: build it, run its step on meta under the counter, and
    write (to ``out_dir``, when given) and return its record."""
    if multi_pod:
        raise NotImplementedError("--multi-pod: JAX's meshes and FSDP split wait for the "
                                  "sharding slice; one card only")
    shape = SHAPES[shape_name] if isinstance(shape_name, str) else shape_name
    rec = {"arch": arch, "shape": shape.name, "mesh": MESH, "kind": shape.kind,
           "variant": variant, "ok": False}
    t0 = time.time()
    try:
        cfg, fn, in_args, n_params = build_cell(arch, shape, smoke=smoke, variant=variant)
        rec["n_params"] = n_params
        rec["t_lower_s"] = round(time.time() - t0, 2)  # building the meta inputs
        t1 = time.time()
        counter, mem = memory(fn, in_args)
        rec["t_compile_s"] = round(time.time() - t1, 2)  # the meta run
        print(f"[{arch} {shape.name} {MESH}] "
              f"mem={mem['temp_size_in_bytes']/2**30:.2f}GiB tmp "
              f"args={mem['argument_size_in_bytes']/2**30:.2f}GiB")
        flops, byts = counter.flops, counter.bytes
        coll = {"by_op": {k: 0 for k in _COLLECTIVES}, "counts": {k: 0 for k in _COLLECTIVES},
                "total": 0}
        rec.update({"raw_flops_per_device": flops, "raw_bytes_per_device": byts,
                    "raw_collectives": coll, "probe": "meta"})
        mf = model_flops(cfg, n_params, shape)
        rec.update({
            "ok": True,
            "memory": mem,
            "flops_per_device": flops,
            "bytes_per_device": byts,
            "collectives": coll,
            "n_chips": 1,
            "model_flops_global": mf,
            "flops_tensor_core": counter.flops_tensor_core,
            "flops_other": counter.flops_other,
            "kernels": counter.kernels,
            "t_compute": (counter.flops_tensor_core / PEAK_FLOPS
                          + counter.flops_other / PEAK_FLOPS_FP32),
            "t_memory": byts / HBM_BW,
            "t_collective": 0.0,
            "useful_flops_frac": mf / flops if flops else None,
        })
        terms = {"compute": rec["t_compute"], "memory": rec["t_memory"],
                 "collective": rec["t_collective"]}
        rec["bottleneck"] = max(terms, key=terms.get)
        print(f"  flops/dev={flops:.3e} bytes/dev={byts:.3e} "
              f"coll=0B -> {rec['bottleneck']}-bound "
              f"(c={rec['t_compute']*1e3:.1f}ms m={rec['t_memory']*1e3:.1f}ms "
              f"x=0.0ms) probe=meta")
    except Exception as e:  # a cell's failure is its record; the others go on
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()
        print(f"[{arch} {shape.name} {MESH}] FAIL {rec['error']}")
    rec["t_total_s"] = round(time.time() - t0, 2)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        suffix = "" if variant == "baseline" else f"__{variant}"
        safe = f"{arch}__{shape.name}__{MESH}{suffix}".replace("/", "_")
        with open(os.path.join(out_dir, safe + ".json"), "w") as f:
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
    if args.multi_pod or args.both:
        raise NotImplementedError("--multi-pod/--both: JAX's production meshes wait for the "
                                  "sharding slice; the port's dry run is one card")
    if not args.all and not (args.arch and args.shape):
        ap.error("--arch and --shape, or --all")

    cells = (registry.runnable_cells(smoke=args.smoke) if args.all
             else [(args.arch, args.shape)])
    n_ok = n_fail = 0
    for arch, shape_name in cells:
        if args.skip_done and args.out:
            p = os.path.join(args.out, f"{arch}__{shape_name}__{MESH}.json")
            if os.path.exists(p):
                with open(p) as f:
                    if json.load(f).get("ok"):
                        n_ok += 1
                        continue
        rec = run_cell(arch, shape_name, smoke=args.smoke, out_dir=args.out,
                       variant=args.variant)
        n_ok += rec["ok"]
        n_fail += not rec["ok"]
    print(f"\ndry-run: {n_ok} ok, {n_fail} failed")
    raise SystemExit(1 if n_fail else 0)


if __name__ == "__main__":
    main()
