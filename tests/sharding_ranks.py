"""Rank code of the port's sharding tests, torch only (no JAX), and the
launcher that runs it on gloo ranks on the CPU.

:func:`launch` starts one ``python sharding_ranks.py RANK WORLD DIR TIMEOUT``
process per rank (``OMP_NUM_THREADS=1``, one torch thread), which joins a
gloo group over a ``file://`` store in ``DIR`` (no port, so test workers
never meet), runs ``CASES[name](rank, **inputs)`` for each case the test
pickled into ``DIR/inputs.pkl``, in order, and pickles its results to
``DIR/rank<R>.pkl``. The group and the launcher each have a timeout, so a
hung collective fails its test instead of running out the suite's clock.
Every rank runs the same collectives in the same order.
"""
from __future__ import annotations

import contextlib
import datetime
import os
import pickle
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

HERE = Path(__file__).resolve().parent
SRC = HERE.parent / "src"


def launch(workdir, world: int, timeout: float = 120.0, **cases) -> list:
    """Run each of ``cases`` ({case name: its keyword inputs}, in order) on
    the same ``world`` gloo ranks; returns each rank's {case: result}.
    Raises (after killing the ranks) if a rank fails or the group outlives
    ``timeout`` seconds."""
    workdir = Path(workdir)
    workdir.mkdir(parents=True, exist_ok=True)
    with open(workdir / "inputs.pkl", "wb") as f:
        pickle.dump(cases, f)
    env = {**os.environ, "OMP_NUM_THREADS": "1",
           "PYTHONPATH": os.pathsep.join([str(SRC), str(HERE), os.environ.get("PYTHONPATH", "")])}
    procs = [subprocess.Popen([sys.executable, str(Path(__file__)), str(r), str(world),
                               str(workdir), str(timeout)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    deadline = time.monotonic() + timeout + 30
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=max(1.0, deadline - time.monotonic()))
            outs.append(out)
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        raise AssertionError(f"{list(cases)}: ranks still running after {timeout} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise AssertionError(f"{list(cases)}: rank {r} exited {p.returncode}:\n{out[-6000:]}")
    results = []
    for r in range(world):
        with open(workdir / f"rank{r}.pkl", "rb") as f:
            results.append(pickle.load(f))
    return results


# --------------------------------------------------------------------------
# helpers the cases share
# --------------------------------------------------------------------------
def _np(t) -> np.ndarray:
    from torch.distributed.tensor import DTensor

    if isinstance(t, DTensor):
        t = t.full_tensor()
    return t.detach().float().numpy()


def flat(tree: dict, prefix: str = "") -> dict:
    """A parameter tree flattened to JAX's dotted paths."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def batch_tensors(batch_np: dict) -> dict:
    """The batch's tensors from numpy (bf16 stubs arrive as fp32)."""
    out = {}
    for k, v in batch_np.items():
        t = torch.as_tensor(v)
        out[k] = t.to(torch.bfloat16) if k in ("frames", "patch_embeds") else t
    return out


@contextlib.contextmanager
def router_record(log: list):
    """Record every router call's expert ids (the port's ``router_topk``,
    run on whole local copies under a mesh)."""
    from repro_torch.models import moe

    orig = moe.router_topk

    def rec(p, x, k, **kw):
        out = orig(p, x, k, **kw)
        log.append(out[1].numpy().copy())
        return out

    moe.router_topk = rec
    try:
        yield log
    finally:
        moe.router_topk = orig


def loss_and_grads(arch: str, params_np: dict, batch_np: dict, mesh, cfg_kw: dict) -> dict:
    """The port's SMOKE ``loss_fn`` of ``arch`` and its gradients (each
    brought to its parameter's placement, as the trainer does) from JAX's
    parameters, on ``mesh`` (None: no mesh). Returns numpy: loss, ce, aux,
    {path: gradient} and the routers' expert ids call by call."""
    import dataclasses

    from repro_torch.core import interop
    from repro_torch.launch import shardings as sh
    from repro_torch.launch import train as ttrain
    from repro_torch.models import registry
    from repro_torch.optim import adamw

    cfg = dataclasses.replace(registry.get_config(arch, smoke=True), **cfg_kw)
    mod = registry.get_module(cfg)
    params = interop.lm_params_from_numpy(params_np, "cpu")
    batch = batch_tensors(batch_np)
    if mesh is not None:
        params = sh.distribute(params, sh.replicated(mesh))
        batch = sh.distribute(batch, sh.batch_shardings(mesh, batch))
    for p in adamw.tree_leaves(params):
        p.requires_grad_(True)
    log = []
    with router_record(log), ttrain.mesh_scope(mesh), ttrain.deterministic_algorithms():
        loss, metrics = mod.loss_fn(params, batch, cfg)
        loss.backward()
    with torch.no_grad():
        if mesh is not None:
            grads = {k: ttrain.placed_grad(p) for k, p in flat(params).items()}
        else:
            grads = {k: (p.grad if p.grad is not None else torch.zeros_like(p))
                     for k, p in flat(params).items()}
    return {"loss": float(_np(loss)), "ce": float(_np(metrics["ce"])),
            "aux": float(_np(metrics["aux"])),
            "grads": {k: g.float().numpy() for k, g in grads.items()}, "routers": log}


class LocalFlops(TorchDispatchMode):
    """A dispatch mode that counts the FLOPs of the ops run on plain
    tensors (``torch.utils.flop_counter``'s formulas), by aten op: an op on
    DTensors is passed on to DTensor (``NotImplemented``), whose ops on each
    rank's local tensors then come back through the mode, so the count is
    the rank's own work, collectives aside. The ops DTensor runs on fake
    global shapes to propagate its layouts (once per layout: they hit a
    cache after) are not counted."""

    def __init__(self):
        super().__init__()
        self.flops = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        from torch.utils.flop_counter import flop_registry

        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if torch._C._get_dispatch_mode(torch._C._TorchDispatchModeKey.FAKE) is not None:
            return out  # DTensor's shape propagation on fake global shapes
        packet = func._overloadpacket
        if packet in flop_registry:
            n = flop_registry[packet](*args, **kwargs, out_val=out)
            self.flops[str(packet)] = self.flops.get(str(packet), 0) + int(n)
        return out


def step_flops(arch: str, mesh_shape: tuple, run: dict) -> dict:
    """{aten op: FLOPs} of this rank's first ``TrainRun`` step of ``arch``
    at SMOKE (``run``'s fields) on a ``mesh_shape`` mesh over the world
    group, or with no mesh for ``()``."""
    from repro_torch.data.pipeline import make_batch
    from repro_torch.launch import train as ttrain

    tr = ttrain.TrainRun(arch=arch, device="cpu", mesh_shape=mesh_shape, **run)
    try:
        _, _, dev, params, opt_state, dcfg, step = tr.build()
        batch = make_batch(dcfg, 0, dev)
        with LocalFlops() as count:
            step(params, opt_state, batch)
    finally:
        tr.close()
    return count.flops


# --------------------------------------------------------------------------
# cases: each runs on every rank and returns a picklable result
# --------------------------------------------------------------------------
def case_families(rank: int, cases: list, params: dict, batches: dict) -> dict:
    """Each case ``(name, arch, inputs key, config fields)``: ``loss_fn`` and
    its gradients on a (2, 2) mesh from ``params[key]`` and ``batches[key]``
    (rank 0 returns them; every rank its loss and routers), and on rank
    ``i % 4`` for case i the port without a mesh on the same inputs."""
    import torch.distributed as dist

    from repro_torch.launch import mesh as mesh_lib

    mesh = mesh_lib.make_mesh((2, 2), ("data", "model"), "cpu")
    out = {}
    for i, (name, arch, key, cfg_kw) in enumerate(cases):
        r = loss_and_grads(arch, params[key], batches[key], mesh, cfg_kw)
        if rank != 0:
            r = {"loss": r["loss"], "routers": r["routers"]}
        if i % dist.get_world_size() == rank:
            r["plain"] = loss_and_grads(arch, params[key], batches[key], None, cfg_kw)
        out[name] = r
    return out


def case_train(rank: int, params: dict, run: dict, ckpt_root: str) -> dict:
    """``TrainRun(mesh_shape=(2, 2))`` of llama3.2-3b at SMOKE from JAX's
    parameters; the placements each gradient had before and after
    ``placed_grad`` on the first step; a run with the gradients left in
    their placements (``Partial`` kept: a rank's own part only); and a run
    checkpointed and resumed, against the same run uninterrupted."""
    from torch.distributed.tensor import Replicate

    from repro_torch.core import interop
    from repro_torch.launch import train as ttrain

    pt0 = interop.lm_params_from_numpy(params, "cpu")
    kw = dict(arch="llama3.2-3b", device="cpu", **run)
    seen = []
    clean = ttrain.placed_grad

    def recording(p):
        g = clean(p)
        if len(seen) < len(flat(pt0)):
            seen.append((tuple(repr(x) for x in p.grad.placements),
                         tuple(repr(x) for x in p.placements),
                         tuple(g.shape) == tuple(p.shape)))
        return g

    ttrain.placed_grad = recording
    try:
        out = ttrain.TrainRun(mesh_shape=(2, 2), params=pt0, **kw).run()
    finally:
        ttrain.placed_grad = clean

    def trees(o):
        return {"params": {k: _np(v) for k, v in flat(o["params"]).items()},
                "mu": {k: _np(v) for k, v in flat(o["opt_state"].mu).items()},
                "nu": {k: _np(v) for k, v in flat(o["opt_state"].nu).items()},
                "step": int(o["opt_state"].step)}

    res = {"losses": out["losses"], "grad_norms": out["grad_norms"], "placements": seen,
           **trees(out)}

    def left_partial(p):
        g = p.grad
        keep = [x if x.is_partial() else Replicate() for x in g.placements]
        return g.redistribute(g.device_mesh, keep).to_local().contiguous()

    ttrain.placed_grad = left_partial
    try:
        res["planted"] = trees(ttrain.TrainRun(mesh_shape=(2, 2), params=pt0, **kw).run())
    finally:
        ttrain.placed_grad = clean

    resume = dict(kw, steps=4, ckpt_every=2, ckpt_async=False)
    whole = ttrain.TrainRun(mesh_shape=(2, 2), params=pt0, **resume).run()
    d = f"{ckpt_root}/resume"
    ttrain.TrainRun(mesh_shape=(2, 2), params=pt0, ckpt_dir=d, **{**resume, "steps": 2}).run()
    resumed = ttrain.TrainRun(mesh_shape=(2, 2), params=pt0, ckpt_dir=d, **resume).run()
    res["resume"] = {"whole": (whole["losses"], trees(whole)),
                     "resumed": (resumed["losses"], trees(resumed))}
    return res


def case_collectives(rank: int, grads: np.ndarray, carry: np.ndarray, tree: dict,
                     specs: dict) -> dict:
    """``all_reduce_compressed`` of rank r's gradient ``grads[r]`` (with
    ``carry[r]``) over the world group, its int32 residual sums as the
    wire summed them; and a ``reshard`` round trip of ``tree`` onto a
    (2, 2) mesh's shardings of ``specs`` and back through ``full_tensor``."""
    import torch.distributed as dist

    from repro_torch.checkpoint.manager import reshard
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models.partitioning import NamedSharding, P
    from repro_torch.optim import compress

    sums = []
    orig = dist.all_reduce

    def rec(t, op=dist.ReduceOp.SUM, group=None, async_op=False):
        w = orig(t, op=op, group=group, async_op=async_op)
        if t.dtype == torch.int32:
            sums.append(t.numpy().copy())
        return w

    dist.all_reduce = rec
    try:
        mean, new_carry = compress.all_reduce_compressed(
            torch.as_tensor(grads[rank]), dist.group.WORLD, torch.as_tensor(carry[rank]))
    finally:
        dist.all_reduce = orig
    mesh = mesh_lib.make_mesh((2, 2), ("data", "model"), "cpu")
    shardings = {k: NamedSharding(mesh, P(*s)) for k, s in specs.items()}
    dev = reshard(tree, shardings)
    back = {k: _np(v) for k, v in dev.items()}
    local = {k: (tuple(repr(x) for x in v.placements), tuple(v.to_local().shape))
             for k, v in dev.items()}
    return {"mean": mean.numpy(), "carry": new_carry.numpy(), "resid_sum": sums,
            "back": back, "local": local}


def case_flops(rank: int, archs: list, run: dict) -> dict:
    """{arch: ({op: FLOPs} of this rank's SMOKE train step on a (2, 2)
    mesh, the same without a mesh)} (:func:`step_flops`)."""
    return {a: (step_flops(a, (2, 2), run), step_flops(a, (), run)) for a in archs}


def case_fsdp_step(rank: int, params: dict, batch: dict, steps: int) -> dict:
    """One ``train_step`` of llama3.2-3b at SMOKE on a (2, 2) mesh from
    JAX's parameters and ``batch``, twice: the parameters and moments
    replicated (``TrainRun``'s layout) and laid out by
    ``param_shardings(fsdp=True)`` (the dry run's: FSDP over "data", TP
    over "model"). Returns each run's loss, grad norm, the placements of
    the sharded run's parameters, ``whole_norm``, and (rank 0) the updated parameters and
    moments whole; ``steps`` sets the optimizer's schedule as ``TrainRun``'s.
    ``whole_norm`` is the norm of the gradients AdamW was handed, each
    gathered whole (``full_tensor``) and summed as one device would."""
    from torch.distributed.tensor import DTensor

    from repro_torch.core import interop
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import shardings as sh
    from repro_torch.launch import train as ttrain
    from repro_torch.models import registry
    from repro_torch.optim import adamw

    mesh = mesh_lib.make_mesh((2, 2), ("data", "model"), "cpu")
    cfg = registry.get_config("llama3.2-3b", smoke=True)
    mod = registry.get_module(cfg)
    ocfg = adamw.OptConfig(lr=1e-3, warmup_steps=20, total_steps=steps)
    out = {}
    for name, fsdp in (("replicated", False), ("fsdp", True)):
        p0 = adamw.tree_map(lambda t: t.clone(), interop.lm_params_from_numpy(params, "cpu"))
        opt = adamw.init(p0)
        shard = sh.param_shardings(mesh, p0, fsdp=True) if fsdp else sh.replicated(mesh)
        p = sh.distribute(p0, shard)
        opt = opt._replace(mu=sh.distribute(opt.mu, shard), nu=sh.distribute(opt.nu, shard))
        for t in adamw.tree_leaves(p):
            t.requires_grad_(True)
        b = batch_tensors(batch)
        b = sh.distribute(b, sh.batch_shardings(mesh, b))
        whole = []
        apply = adamw.apply_updates

        def recording(ocfg_, params_, grads, *args, _p=p, **kw):
            """The norm of the gradients AdamW is handed, gathered whole."""
            full = [DTensor.from_local(g, d.device_mesh, d.placements, shape=d.shape,
                                       stride=d.stride()).full_tensor()
                    for g, d in zip(adamw.tree_leaves(grads), adamw.tree_leaves(_p))]
            whole.append(float(adamw.global_norm({str(i): g for i, g in enumerate(full)})))
            return apply(ocfg_, params_, grads, *args, **kw)

        adamw.apply_updates = recording
        try:
            with ttrain.mesh_scope(mesh):
                p, opt, m = ttrain.train_step(mod, cfg, ocfg, p, opt, b)
        finally:
            adamw.apply_updates = apply
        r = {"loss": float(_np(m["loss"])), "grad_norm": float(m["grad_norm"]),
             "whole_norm": whole[0],
             "placements": {k: tuple(repr(x) for x in v.placements) for k, v in flat(p).items()}}
        trees = {k: {key: _np(v) for key, v in flat(t).items()}
                 for k, t in (("params", p), ("mu", opt.mu), ("nu", opt.nu))}
        if rank == 0:
            r.update(trees, step=int(opt.step))
        out[name] = r
    return out


def filled(tree, gen: torch.Generator):
    """The dry run's meta tree (DTensors of meta shards included) with CPU
    tensors of the same shapes, placements, dtypes and ``requires_grad``:
    normal floats, zero integers (token ids in range)."""
    from torch.distributed.tensor import DTensor

    def real(t):
        if isinstance(t, DTensor):
            local = real(t.to_local()).detach()
            out = DTensor.from_local(local, t.device_mesh, t.placements, run_check=False,
                                     shape=t.shape, stride=t.stride())
            return out.requires_grad_(t.requires_grad)
        x = (torch.randn(t.shape, generator=gen).to(t.dtype) if t.dtype.is_floating_point
             else torch.zeros(t.shape, dtype=t.dtype))
        return x.requires_grad_(t.requires_grad)

    if isinstance(tree, torch.Tensor):
        return real(tree)
    if isinstance(tree, dict):
        return {k: filled(v, gen) for k, v in tree.items()}
    if hasattr(tree, "_fields"):
        return type(tree)(*(filled(v, gen) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(filled(v, gen) for v in tree)
    return tree


def dry_cell_counts(arch: str, kind: str, batch: int, seq: int, mesh, fill: bool) -> dict:
    """The dry run's SMOKE cell of ``arch`` (a ``kind`` step at ``batch`` x
    ``seq``) on ``mesh``, counted by its ``CostCounter``: {"flops_by_op",
    "kernels", "collectives"}. ``fill``: on CPU tensors of the cell's
    shapes and layouts (:func:`filled`) instead of its meta ones."""
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.launch import dryrun

    cfg, fn, args, _ = dryrun.build_cell(arch, ShapeSpec(kind, seq, batch, kind), smoke=True,
                                         mesh=mesh)
    if fill:
        args = filled(args, torch.Generator().manual_seed(0))
    counter, _ = dryrun.memory(fn, args)
    return {"flops_by_op": counter.flops_by_op, "kernels": counter.kernels,
            "collectives": counter.collectives}


def case_dry_cells(rank: int, cells: list) -> dict:
    """Each (arch, kind, batch, seq) of ``cells``: :func:`dry_cell_counts`
    on a (2, 2) mesh of the gloo ranks, on CPU tensors."""
    from repro_torch.launch import mesh as mesh_lib

    mesh = mesh_lib.make_mesh((2, 2), ("data", "model"), "cpu")
    return {tuple(c): dry_cell_counts(*c, mesh, fill=True) for c in cells}


def case_decode(rank: int, cells: list, steps: int) -> dict:
    """Each (arch, kv_mode, batch, max_len) of ``cells``: the SMOKE model
    (fp32 parameters from seed 0) prefills a 128-token prompt without a
    mesh, then decodes ``steps`` tokens twice from copies of that cache:
    without a mesh, and on a (2, 2) mesh with the cache on JAX's
    ``cache_shardings`` layout (the dry run's) and the parameters
    replicated. Returns the two runs' logits a step and, for the first
    layer's cache leaves, whether the mesh run's are bit-equal."""
    import dataclasses

    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import shardings as sh
    from repro_torch.launch import train as ttrain
    from repro_torch.launch.serve import modality_inputs
    from repro_torch.models import partitioning as pt
    from repro_torch.models import registry

    mesh = mesh_lib.make_mesh((2, 2), ("data", "model"), "cpu")
    out = {}
    for arch, mode, b, max_len in cells:
        cfg = dataclasses.replace(registry.get_config(arch, smoke=True), kv_mode=mode)
        mod = registry.get_module(cfg)
        params = mod.init_params(torch.Generator().manual_seed(0), cfg)
        gen = torch.Generator().manual_seed(1)
        prompt = torch.randint(0, cfg.vocab, (b, 128), generator=gen, dtype=torch.int32)
        toks = torch.randint(0, cfg.vocab, (steps, b, 1), generator=gen, dtype=torch.int32)
        with torch.no_grad():
            _, cache0 = mod.prefill(params, prompt, cfg, max_len,
                                    **modality_inputs(cfg, b, "cpu"))
            runs = {}
            for name in ("plain", "mesh"):
                cache = pt.tree_map(lambda t: t.clone(), cache0)
                p, shard = params, None
                if name == "mesh":
                    shard = sh.cache_shardings(mesh, cache, b, max_len)
                    cache = sh.distribute(cache, shard)
                    p = sh.distribute(params, sh.replicated(mesh))
                logits = []
                with ttrain.mesh_scope(mesh if name == "mesh" else None):
                    for tok in toks:
                        if name == "mesh":
                            tok = sh.distribute(tok, sh.batch_shardings(mesh, tok))
                        lg, cache = mod.decode_step(p, tok, cache, cfg)
                        logits.append(_np(lg))
                first = [_np(t[0]) if t.dim() >= 1 else _np(t) for t in _leaves(cache)]
                runs[name] = (logits, first,
                              [str(s.spec) for s in _leaves(shard)] if shard else None)
        out[(arch, mode, b, max_len)] = {
            "plain": runs["plain"][0], "mesh": runs["mesh"][0], "specs": runs["mesh"][2],
            "first_layer_equal": [bool(np.array_equal(a, c)) for a, c in
                                  zip(runs["plain"][1], runs["mesh"][1])],
            "first_layer_rel": [float(np.abs(a - c).max() / max(np.abs(a).max(), 1e-30))
                                for a, c in zip(runs["plain"][1], runs["mesh"][1])]}
    return out


def _leaves(tree) -> list:
    """The tensors (or shardings) of a cache's NamedTuples, in field order."""
    if hasattr(tree, "_fields"):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


CASES = {"families": case_families, "train": case_train, "collectives": case_collectives,
         "flops": case_flops, "fsdp_step": case_fsdp_step, "dry_cells": case_dry_cells,
         "decode": case_decode}


def _main(rank: int, world: int, workdir: str, timeout: float):
    import torch.distributed as dist

    torch.set_num_threads(1)
    with open(Path(workdir) / "inputs.pkl", "rb") as f:
        cases = pickle.load(f)
    dist.init_process_group("gloo", init_method=f"file://{workdir}/store", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=timeout))
    try:
        result = {name: CASES[name](rank, **kw) for name, kw in cases.items()}
        dist.barrier()
    finally:
        dist.destroy_process_group()
    with open(Path(workdir) / f"rank{rank}.pkl", "wb") as f:
        pickle.dump(result, f)


if __name__ == "__main__":
    _main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], float(sys.argv[4]))
