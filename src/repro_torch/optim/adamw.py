"""AdamW + cosine schedule + global-norm clipping, hand-rolled in torch.

Port of ``repro.optim.adamw`` with its arithmetic element by element:
moments fp32 whatever the parameters' dtype, decay only for leaves of
ndim >= 2 (the stacked (n_layers, d) norm weights included, as in JAX),
bias correction from the new step, ``p - lr * u`` in fp32.

Unlike JAX's tree maps, :func:`apply_updates` works IN PLACE: it scales
the gradients, updates ``mu`` and ``nu`` and writes the new parameters
into the tensors it was given, a slice of each leaf at a time. A
functional update would hold new fp32 moments and parameters beside the
old ones: 38.5 GB more for llama3.2-3b's 3.2e9 parameters, past an 80 GB
card. Trees are nested dicts of tensors (the models' parameter trees).
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

#: Elements per slice of a leaf that one in-place update touches at a time
#: (a few leaf-sized fp32 temporaries would cost GBs at full width).
CHUNK = 1 << 25


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_frac: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


class OptState(NamedTuple):
    step: torch.Tensor  # () int32
    mu: dict  # first moments (fp32)
    nu: dict  # second moments (fp32)


def tree_leaves(tree) -> list:
    """The tensors of a nested dict, in insertion order (JAX's sorted-key
    order differs; every reduction here is over all leaves)."""
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in tree_leaves(v)]
    return [tree]


def tree_map(fn, tree, *rest):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    return fn(tree, *rest)


def init(params) -> OptState:
    dev = tree_leaves(params)[0].device
    return OptState(
        step=torch.zeros((), dtype=torch.int32, device=dev),
        mu=tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
                    params),
        nu=tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
                    params))


def schedule(cfg: OptConfig, step: torch.Tensor) -> torch.Tensor:
    s = step.float()
    warm = s / max(1.0, cfg.warmup_steps)
    prog = (s - cfg.warmup_steps) / max(1.0, cfg.total_steps - cfg.warmup_steps)
    prog = torch.clamp(prog, 0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (1.0 + torch.cos(math.pi * prog))
    return cfg.lr * torch.where(s < cfg.warmup_steps, warm, cos)


def _chunks(t: torch.Tensor):
    """1-D views of a contiguous tensor, CHUNK elements at a time."""
    flat = t.view(-1)
    for i in range(0, flat.numel(), CHUNK):
        yield flat[i:i + CHUNK]


def global_norm(tree) -> torch.Tensor:
    total = 0
    for x in tree_leaves(tree):
        total = total + sum(torch.sum(torch.square(c.float())) for c in _chunks(x))
    return torch.sqrt(total)


def clip_by_global_norm(grads, max_norm: float):
    """Scale ``grads`` IN PLACE to global norm at most ``max_norm``;
    returns (grads, the norm before scaling)."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    for g in tree_leaves(grads):
        g.mul_(scale)
    return grads, norm


def _decay_mask(path_leaf) -> bool:
    """No weight decay on norms/biases/scalars (1-D params)."""
    return path_leaf.ndim >= 2


def apply_updates(cfg: OptConfig, params, grads, state: OptState):
    """One AdamW step IN PLACE. Returns (params, new state, metrics):
    ``params``, ``state.mu`` and ``state.nu`` are the tensors passed in,
    updated; ``grads`` (fp32, or cast to fp32 first) are scaled by the
    clip. The parameters' gradients do not flow through this."""
    with torch.no_grad():
        grads = tree_map(lambda g: g if g.dtype == torch.float32 else g.float(), grads)
        grads, gnorm = clip_by_global_norm(grads, cfg.clip_norm)
        step = state.step + 1
        lr = schedule(cfg, step)
        b1, b2 = cfg.b1, cfg.b2
        bc1 = 1.0 - torch.pow(torch.tensor(b1, dtype=torch.float32, device=step.device),
                              step.float())
        bc2 = 1.0 - torch.pow(torch.tensor(b2, dtype=torch.float32, device=step.device),
                              step.float())
        for p, g, m, v in zip(*(tree_leaves(t) for t in (params, grads, state.mu, state.nu))):
            decay = _decay_mask(p)
            for pc, gc, mc, vc in zip(*(_chunks(t) for t in (p, g, m, v))):
                mc.mul_(b1).add_(gc * (1 - b1))
                vc.mul_(b2).add_(gc * (1 - b2) * gc)
                u = (mc / bc1).div_(torch.sqrt(vc / bc2).add_(cfg.eps))
                pf = pc.float()
                if decay:
                    u.add_(cfg.weight_decay * pf)
                pc.copy_(pf - lr * u)
    return params, OptState(step=step, mu=state.mu, nu=state.nu), {"lr": lr, "grad_norm": gnorm}
