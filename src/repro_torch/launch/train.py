"""Training driver: data pipeline -> train step (loss, backward, AdamW)
-> checkpoint/restart -> heartbeat + straggler watchdog.

Port of ``repro.launch.train``. Where JAX takes ``jax.value_and_grad``
of ``loss_fn`` under ``jax.jit``, a step here (:func:`train_step`) runs
the family's ``loss_fn`` forward, ``loss.backward()`` and
``optim.adamw.apply_updates`` (in place); with the config's
``remat="full"`` the backward recomputes each layer body. On the GPU
the attention's gradient is the hand-written K7b
(``kernels.flash_attention``); on the CPU its plain version. Parameters
are fp32 masters; the forward casts each weight to bf16 at use, as JAX
does.

``mesh_shape=(d, m)`` trains on a ("data", "model") mesh
(``launch.mesh.make_mesh``: one process per device, over the caller's
process group, or on one device a group of its own), as JAX's ``TrainRun``
does under ``jax.set_mesh``: the fp32 masters, AdamW's moments and the
batch are replicated DTensors (the batch's rows over "data" where they
divide), and the models' sharding hints (``models.partitioning``) lay the
activations out while the steps run (``partitioning.use_mesh``). Tensors
the models make inside (masks, positions, tables) count as replicated
(``implicit_replication``). Each gradient is brought to its parameter's
placement (:func:`placed_grad`: a sum over the ranks that hold parts of
it) before AdamW updates each rank's copy in place, clipped by the norm
over every rank's shards (:func:`mesh_grad_norm`). Rank 0 writes
the checkpoints; a resume broadcasts them. Every rank returns its losses,
which are the same on every rank.

  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-3b --smoke \\
      --steps 4 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-3b \\
      --steps 6 --batch 2 --seq 1024          # on the GPU, full size
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.checkpoint.manager import CheckpointManager, reshard
from repro_torch.core.solver import resolve_device
from repro_torch.data.pipeline import DataConfig, make_batch
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import shardings as sh
from repro_torch.models import partitioning as pt
from repro_torch.models import registry
from repro_torch.optim import adamw
from repro_torch.runtime.fault_tolerance import (HeartbeatMonitor, HeartbeatWriter,
                                                 StragglerWatchdog, TrainGuard)


@contextlib.contextmanager
def deterministic_algorithms():
    """PyTorch's deterministic implementations for the duration (the
    embedding gather's and the MoE gathers' backward scatter-adds, in
    sorted order rather than by atomics, so a run repeats bit for bit),
    uninitialized memory left as it is; the previous settings come back
    after."""
    import torch.utils.deterministic as det

    was, was_warn = torch.are_deterministic_algorithms_enabled(), \
        torch.is_deterministic_algorithms_warn_only_enabled()
    fill = det.fill_uninitialized_memory
    torch.use_deterministic_algorithms(True, warn_only=True)
    det.fill_uninitialized_memory = False
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(was, warn_only=was_warn)
        det.fill_uninitialized_memory = fill


def _stamp(dev: torch.device):
    """A point in the device's work: a CUDA event recorded on the current
    stream (no synchronization), or the host clock on the CPU, where every
    op has finished when it returns."""
    if dev.type == "cuda":
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev
    return time.perf_counter()


def _seconds(a, b) -> float:
    """Seconds between two ``_stamp``s; ``b`` must have completed."""
    if isinstance(a, float):
        return b - a
    return a.elapsed_time(b) * 1e-3


def placed_grad(p: torch.Tensor) -> torch.Tensor:
    """The local tensor of DTensor parameter ``p``'s gradient once it is in
    ``p``'s placements: a gradient that comes back ``Partial`` over an axis
    (a sum of the ranks' parts) is reduced over it, a ``Shard`` gathered;
    zeros where ``p`` took no part. AdamW reads it beside ``p``'s local
    tensor, in its dense layout (a gradient gathered from column shards
    may come back strided)."""
    g = p.grad
    if g is None:
        return torch.zeros_like(p.to_local())
    return g.redistribute(p.device_mesh, p.placements).to_local().contiguous()


def mesh_grad_norm(params: dict, grads: dict) -> torch.Tensor:
    """The global norm of a mesh run's gradients (``grads``: each rank's
    local tensors, in the placements of the DTensor ``params``), as JAX's
    GSPMD computes it over the whole tree: each rank sums the squares of
    the shards it holds, a leaf counted only on the ranks at coordinate 0
    of every mesh axis that does not split it (a replicated leaf once, a
    leaf split over "data" once for each of its shards), and one
    all-reduce over every rank sums them."""
    from torch.distributed import _functional_collectives as funcol
    from torch.distributed.tensor import Shard

    leaves = adamw.tree_leaves(params)
    total = torch.zeros((), dtype=torch.float32, device=_local(leaves[0]).device)
    mesh = None
    for p, g in zip(leaves, adamw.tree_leaves(grads)):
        mesh = p.device_mesh
        coord = mesh.get_coordinate()
        if all(isinstance(pl, Shard) or c == 0 for pl, c in zip(p.placements, coord)):
            total = total + adamw.square_sum(g)
    if mesh.size() > 1:  # a mesh of one device holds every leaf whole
        if mesh.size() != dist.get_world_size():
            raise ValueError(f"the mesh's {mesh.size()} devices are not the world's "
                             f"{dist.get_world_size()} ranks")
        total = funcol.wait_tensor(funcol.all_reduce(total, "sum", dist.group.WORLD))
    return torch.sqrt(total)


def _local(t):
    """A DTensor's local tensor (its storage, outside autograd), else ``t``."""
    return t.to_local() if pt.is_dtensor(t) else t


def train_step(mod, cfg, ocfg: adamw.OptConfig, params: dict, opt_state: adamw.OptState,
               batch: dict, mark=lambda part: None):
    """One training step, IN PLACE: ``mod.loss_fn``'s forward (its layer
    bodies checkpointed under ``cfg.remat``), the backward and AdamW's
    update. ``mark(part)`` is called at the start and after each part
    ("forward", "backward", "optimizer"). Returns (params, opt_state,
    metrics: the loss, the family's metrics, the lr and grad norm). The
    dry run counts this function on meta tensors. DTensor parameters (a
    mesh run, under ``partitioning.use_mesh``) hand AdamW their local
    tensors and :func:`placed_grad`'s gradients."""
    mark("start")
    for p in adamw.tree_leaves(params):
        p.grad = None
    with deterministic_algorithms():
        loss, metrics = mod.loss_fn(params, batch, cfg)
        mark("forward")
        loss.backward()
    mark("backward")
    leaves = adamw.tree_leaves(params)
    if leaves and pt.is_dtensor(leaves[0]):
        with torch.no_grad():
            grads = adamw.tree_map(placed_grad, params)
            local = adamw.OptState(opt_state.step, adamw.tree_map(_local, opt_state.mu),
                                   adamw.tree_map(_local, opt_state.nu))
            _, st, om = adamw.apply_updates(ocfg, adamw.tree_map(_local, params), grads, local,
                                            norm=mesh_grad_norm(params, grads))
        opt_state = opt_state._replace(step=st.step)
    else:
        grads = adamw.tree_map(lambda p: p.grad if p.grad is not None else torch.zeros_like(p),
                               params)
        params, opt_state, om = adamw.apply_updates(ocfg, params, grads, opt_state)
    mark("optimizer")
    return params, opt_state, {"loss": loss.detach(), **metrics, **om}


@contextlib.contextmanager
def mesh_scope(mesh):
    """The block runs with ``mesh`` as the models' current mesh and plain
    tensors counted as replicated beside DTensors; nothing without one."""
    if mesh is None:
        yield
        return
    from torch.distributed.tensor.experimental import implicit_replication

    with pt.use_mesh(mesh), implicit_replication():
        yield


def global_value(t) -> torch.Tensor:
    """A DTensor's whole value on every rank (a collective each rank runs),
    else ``t``."""
    return t.full_tensor() if pt.is_dtensor(t) else t


@dataclasses.dataclass
class TrainRun:
    """Reusable programmatic entry (tests and chip_smoke.py drive this)."""

    arch: str
    smoke: bool = True
    steps: int = 50
    batch: int = 8
    seq: int = 128
    ckpt_dir: str | None = None
    ckpt_every: int = 20
    ckpt_async: bool = True
    mesh_shape: tuple = ()  # () -> single device
    seed: int = 0
    lr: float = 1e-3
    log_every: int = 10
    heartbeat_dir: str | None = None
    device: str | torch.device | None = None  # None -> CUDA (raises without it)
    # 0 keeps the config's depth; n > 0 trains its first n layers at the
    # published widths (a depth cut, as ServeRun's)
    n_layers: int = 0
    # Initial fp32 parameters (the family module's dict, e.g. JAX's carried
    # by ``core.interop.lm_params_from_numpy``), copied; None draws them
    # from ``seed`` on the device.
    params: dict | None = None

    def config(self):
        cfg = registry.get_config(self.arch, smoke=self.smoke)
        return dataclasses.replace(cfg, n_layers=self.n_layers or cfg.n_layers)

    def build(self):
        """(cfg, mod, dev, params, opt_state, dcfg, step): ``step(params,
        opt_state, batch)`` runs :func:`train_step` with the modality stubs.
        With ``mesh_shape``, ``self.mesh`` is the mesh the trees live on
        (else None); :meth:`close` releases a process group it made."""
        dev = resolve_device(self.device)
        self.mesh = (mesh_lib.make_mesh(self.mesh_shape, ("data", "model"), dev)
                     if self.mesh_shape else None)
        mesh = self.mesh
        cfg = self.config()
        mod = registry.get_module(cfg)
        with torch.no_grad():
            if self.params is None:
                params = mod.init_params(torch.Generator(device=dev).manual_seed(self.seed), cfg)
            else:
                params = adamw.tree_map(lambda t: t.detach().to(dev, torch.float32, copy=True),
                                        self.params)
        opt_state = adamw.init(params)
        if mesh is not None:
            rep = sh.replicated(mesh)
            params = sh.distribute(params, rep)
            opt_state = opt_state._replace(mu=sh.distribute(opt_state.mu, rep),
                                           nu=sh.distribute(opt_state.nu, rep))
        for p in adamw.tree_leaves(params):
            p.requires_grad_(True)
        ocfg = adamw.OptConfig(lr=self.lr, warmup_steps=20, total_steps=self.steps)
        dcfg = DataConfig(vocab=cfg.vocab, seq_len=self.seq, global_batch=self.batch,
                          seed=self.seed)
        stubs = self._with_stubs

        def step(params, opt_state, batch):
            """One step. ``metrics["marks"]``: (part, ``_stamp``) at its
            start and after the forward, the backward and the optimizer;
            read them with ``step_parts`` once the step's loss is read."""
            marks = []
            batch = stubs(batch, cfg)
            if mesh is not None:
                batch = sh.distribute(batch, sh.batch_shardings(mesh, batch))
            with mesh_scope(mesh):
                params, opt_state, m = train_step(
                    mod, cfg, ocfg, params, opt_state, batch,
                    mark=lambda part: marks.append((part, _stamp(dev))))
            return params, opt_state, {**m, "marks": marks}

        return cfg, mod, dev, params, opt_state, dcfg, step

    def close(self):
        """Release the process group :meth:`build` made for a one-device
        mesh (a group the caller made stays)."""
        if getattr(self, "mesh", None) is not None:
            self.mesh = None
            mesh_lib.release()

    @staticmethod
    def _with_stubs(batch, cfg):
        """Deterministic modality-stub inputs: encdec frames (B, src_len,
        d_model) and vlm patch embeddings (B, n_patches, d_model), bf16
        standard normals from generators seeded 0 and 1 on the tokens'
        device. JAX draws them from ``jax.random.key(0/1)``, which the port
        cannot reproduce (other numbers, as ``launch/serve.py``'s
        ``modality_inputs``); a batch that carries them is used as given."""
        out = dict(batch)
        tok = batch["tokens"]
        dev, b = tok.device, tok.shape[0]

        def normal(seed, rows):
            gen = torch.Generator(device=dev).manual_seed(seed)
            return torch.randn((b, rows, cfg.d_model), generator=gen, device=dev,
                               dtype=torch.bfloat16)

        if cfg.family == "encdec" and "frames" not in out:
            out["frames"] = normal(0, cfg.src_len)
        if cfg.family == "vlm" and "patch_embeds" not in out:
            out["patch_embeds"] = normal(1, cfg.n_patches)
        return out

    def run(self, on_step=None) -> dict:
        """Train ``steps`` steps (from the checkpoint's step when
        ``ckpt_dir`` holds one). Returns the losses, grad norms, wall
        seconds a step and its parts' (forward, backward, optimizer; from
        CUDA events on the GPU), the final parameters and optimizer state
        (DTensors on a mesh). A process group the run made for its mesh is
        destroyed when it returns or raises."""
        try:
            return self._run(on_step)
        finally:
            self.close()

    def _run(self, on_step) -> dict:
        cfg, mod, dev, params, opt_state, dcfg, step_fn = self.build()
        mesh = self.mesh
        writer = mesh is None or torch.distributed.get_rank() == 0
        start_step = 0
        ckpt = CheckpointManager(self.ckpt_dir) if self.ckpt_dir and writer else None
        if self.ckpt_dir:
            params, opt_state, start_step = self._resume(ckpt, params, opt_state, dev)

        guard = None
        if self.heartbeat_dir:
            guard = TrainGuard(
                heartbeat=HeartbeatWriter(self.heartbeat_dir, 0),
                watchdog=StragglerWatchdog(),
                monitor=HeartbeatMonitor(self.heartbeat_dir),
                expected_hosts=1)

        def save(at: int, blocking: bool):
            tree = pt.tree_map(global_value, (params, opt_state))  # every rank
            if ckpt:
                ckpt.save(at, tree, blocking=blocking)

        losses, grad_norms, step_s, parts = [], [], [], []
        for step in range(start_step, self.steps):
            t0 = time.time()
            params, opt_state, m = step_fn(params, opt_state, make_batch(dcfg, step, dev))
            loss = float(global_value(m["loss"]))  # the step's one synchronization
            parts.append(step_parts(m["marks"]))
            losses.append(loss)
            grad_norms.append(float(m["grad_norm"]))
            dt = time.time() - t0
            step_s.append(dt)
            if guard:
                guard.on_step(step, dt)
            if on_step:
                on_step(step, loss)
            if step % self.log_every == 0 and writer:
                print(f"[train] step {step:5d} loss {loss:.4f} ({dt*1e3:.0f} ms)")
            if self.ckpt_dir and (step + 1) % self.ckpt_every == 0:
                save(step + 1, not self.ckpt_async)
        if self.ckpt_dir:
            save(self.steps, True)
            if ckpt:
                ckpt.close()
        return {"losses": losses, "grad_norms": grad_norms, "step_s": step_s, "parts": parts,
                "params": params, "opt_state": opt_state,
                "final_loss": losses[-1] if losses else None}

    def _resume(self, ckpt, params, opt_state, dev):
        """(params, opt_state, step) from the newest checkpoint, IN PLACE;
        the trees and 0 as given when there is none. On a mesh rank 0
        reads it and ``checkpoint.reshard`` broadcasts its values."""
        mesh = self.mesh
        restored, at = ckpt.restore((params, opt_state)) if ckpt else (None, None)
        if mesh is not None:
            box = [at]
            torch.distributed.broadcast_object_list(box, src=0)
            at = box[0]
        if at is None:
            return params, opt_state, 0
        dst = sum((adamw.tree_leaves(t) for t in (params, opt_state.mu, opt_state.nu)), [])
        if restored is not None:
            src = sum((adamw.tree_leaves(t) for t in (restored[0], restored[1].mu,
                                                      restored[1].nu)), [])
        else:  # a rank other than 0 holds no checkpoint: its values are placeholders
            src = [t.detach().to_local() for t in dst]
        put = dev if mesh is None else sh.replicated(mesh)
        with torch.no_grad():
            for t, a in zip(dst, src, strict=True):  # one leaf at a time
                _local(t).copy_(_local(reshard(a, put)))
        step = int(np.asarray(restored[1].step)) if restored is not None else 0
        step_t = torch.tensor(step, dtype=torch.int32, device=dev)
        if mesh is not None:
            torch.distributed.broadcast(step_t, src=0)
        opt_state = opt_state._replace(step=step_t)
        if restored is not None:
            print(f"[train] resumed from step {at}")
        return params, opt_state, at


def step_parts(marks: list) -> dict:
    """{part: seconds} of a step's ``marks``, each part from the mark
    before it; waits for the last mark (after the step's loss was read, it
    has completed)."""
    last = marks[-1][1]
    if not isinstance(last, float):
        last.synchronize()
    return {b[0]: _seconds(a[1], b[1]) for a, b in zip(marks, marks[1:])}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mamba2-130m", choices=registry.ARCH_IDS)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir")
    ap.add_argument("--heartbeat-dir")
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--device", default=None, help="default: cuda (raises without a GPU)")
    args = ap.parse_args()
    run = TrainRun(arch=args.arch, smoke=args.smoke, steps=args.steps, batch=args.batch,
                   seq=args.seq, ckpt_dir=args.ckpt_dir, heartbeat_dir=args.heartbeat_dir,
                   lr=args.lr, device=args.device)
    out = run.run()
    print(f"[train] done; final loss {out['final_loss']:.4f}")


if __name__ == "__main__":
    main()
