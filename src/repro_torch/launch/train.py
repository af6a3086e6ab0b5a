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
does. One card: ``mesh_shape`` other than () raises until the sharding
slice.

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

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.core.solver import resolve_device
from repro_torch.data.pipeline import DataConfig, make_batch
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


def train_step(mod, cfg, ocfg: adamw.OptConfig, params: dict, opt_state: adamw.OptState,
               batch: dict, mark=lambda part: None):
    """One training step, IN PLACE: ``mod.loss_fn``'s forward (its layer
    bodies checkpointed under ``cfg.remat``), the backward and AdamW's
    update. ``mark(part)`` is called at the start and after each part
    ("forward", "backward", "optimizer"). Returns (params, opt_state,
    metrics: the loss, the family's metrics, the lr and grad norm). The
    dry run counts this function on meta tensors."""
    mark("start")
    for p in adamw.tree_leaves(params):
        p.grad = None
    with deterministic_algorithms():
        loss, metrics = mod.loss_fn(params, batch, cfg)
        mark("forward")
        loss.backward()
    mark("backward")
    grads = adamw.tree_map(lambda p: p.grad if p.grad is not None else torch.zeros_like(p),
                           params)
    params, opt_state, om = adamw.apply_updates(ocfg, params, grads, opt_state)
    mark("optimizer")
    return params, opt_state, {"loss": loss.detach(), **metrics, **om}


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
        opt_state, batch)`` runs :func:`train_step` with the modality stubs."""
        if self.mesh_shape:
            raise NotImplementedError(
                f"mesh_shape {self.mesh_shape}: sharding is not ported; one device only")
        dev = resolve_device(self.device)
        cfg = self.config()
        mod = registry.get_module(cfg)
        with torch.no_grad():
            if self.params is None:
                params = mod.init_params(torch.Generator(device=dev).manual_seed(self.seed), cfg)
            else:
                params = adamw.tree_map(lambda t: t.detach().to(dev, torch.float32, copy=True),
                                        self.params)
        for p in adamw.tree_leaves(params):
            p.requires_grad_(True)
        opt_state = adamw.init(params)
        ocfg = adamw.OptConfig(lr=self.lr, warmup_steps=20, total_steps=self.steps)
        dcfg = DataConfig(vocab=cfg.vocab, seq_len=self.seq, global_batch=self.batch,
                          seed=self.seed)
        stubs = self._with_stubs

        def step(params, opt_state, batch):
            """One step. ``metrics["marks"]``: (part, ``_stamp``) at its
            start and after the forward, the backward and the optimizer;
            read them with ``step_parts`` once the step's loss is read."""
            marks = []
            params, opt_state, m = train_step(
                mod, cfg, ocfg, params, opt_state, stubs(batch, cfg),
                mark=lambda part: marks.append((part, _stamp(dev))))
            return params, opt_state, {**m, "marks": marks}

        return cfg, mod, dev, params, opt_state, dcfg, step

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
        CUDA events on the GPU), the final parameters and optimizer state."""
        cfg, mod, dev, params, opt_state, dcfg, step_fn = self.build()
        start_step = 0
        ckpt = CheckpointManager(self.ckpt_dir) if self.ckpt_dir else None
        if ckpt is not None:
            restored, at = ckpt.restore((params, opt_state))
            if restored is not None:
                with torch.no_grad():
                    for t, a in zip(adamw.tree_leaves(params) + adamw.tree_leaves(opt_state.mu)
                                    + adamw.tree_leaves(opt_state.nu),
                                    adamw.tree_leaves(restored[0])
                                    + adamw.tree_leaves(restored[1].mu)
                                    + adamw.tree_leaves(restored[1].nu)):
                        t.copy_(torch.from_numpy(np.asarray(a)))
                opt_state = opt_state._replace(step=torch.tensor(
                    np.asarray(restored[1].step).astype(np.int32), device=dev))
                start_step = at
                print(f"[train] resumed from step {at}")

        guard = None
        if self.heartbeat_dir:
            guard = TrainGuard(
                heartbeat=HeartbeatWriter(self.heartbeat_dir, 0),
                watchdog=StragglerWatchdog(),
                monitor=HeartbeatMonitor(self.heartbeat_dir),
                expected_hosts=1)

        losses, grad_norms, step_s, parts = [], [], [], []
        for step in range(start_step, self.steps):
            t0 = time.time()
            params, opt_state, m = step_fn(params, opt_state, make_batch(dcfg, step, dev))
            loss = float(m["loss"])  # the step's one synchronization
            parts.append(step_parts(m["marks"]))
            losses.append(loss)
            grad_norms.append(float(m["grad_norm"]))
            dt = time.time() - t0
            step_s.append(dt)
            if guard:
                guard.on_step(step, dt)
            if on_step:
                on_step(step, loss)
            if step % self.log_every == 0:
                print(f"[train] step {step:5d} loss {loss:.4f} ({dt*1e3:.0f} ms)")
            if ckpt and (step + 1) % self.ckpt_every == 0:
                ckpt.save(step + 1, (params, opt_state), blocking=not self.ckpt_async)
        if ckpt:
            ckpt.save(self.steps, (params, opt_state), blocking=True)
            ckpt.close()
        return {"losses": losses, "grad_norms": grad_norms, "step_s": step_s, "parts": parts,
                "params": params, "opt_state": opt_state,
                "final_loss": losses[-1] if losses else None}


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
