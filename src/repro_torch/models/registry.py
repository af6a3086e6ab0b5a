"""Architecture registry: --arch <id> -> configs, module entry points,
and meta-tensor input specs for every (arch x shape) dry-run cell.

Port of ``repro.models.registry``: every id of the JAX package, its
config module and its family's module; the abstract specs are tensors on
``torch.device("meta")`` (shapes and dtypes, nothing allocated), where
JAX's are ``ShapeDtypeStruct``s.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs.shapes import SHAPES, ShapeSpec, runnable
from repro_torch.configs import (deepseek_moe_16b, deepseek_v2_236b, granite_3_8b,
                                 internlm2_20b, llama3_2_3b, mamba2_130m, pixtral_12b,
                                 stablelm_1_6b, whisper_large_v3, zamba2_1_2b)
from repro_torch.models import encdec, hybrid, layers, transformer

ARCH_MODULES = {
    "granite-3-8b": granite_3_8b,
    "stablelm-1.6b": stablelm_1_6b,
    "internlm2-20b": internlm2_20b,
    "llama3.2-3b": llama3_2_3b,
    "deepseek-v2-236b": deepseek_v2_236b,
    "deepseek-moe-16b": deepseek_moe_16b,
    "whisper-large-v3": whisper_large_v3,
    "zamba2-1.2b": zamba2_1_2b,
    "pixtral-12b": pixtral_12b,
    "mamba2-130m": mamba2_130m,
}

ARCH_IDS = list(ARCH_MODULES)


def get_config(arch: str, smoke: bool = False) -> transformer.ArchConfig:
    if arch not in ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {ARCH_IDS}")
    mod = ARCH_MODULES[arch]
    return mod.SMOKE if smoke else mod.CONFIG


def get_module(cfg: transformer.ArchConfig):
    """The model module implementing this family's entry points."""
    if cfg.family == "hybrid":
        return hybrid
    if cfg.family == "encdec":
        return encdec
    return transformer


def init_params(gen: torch.Generator, cfg: transformer.ArchConfig,
                dtype=torch.float32) -> dict:
    return get_module(cfg).init_params(gen, cfg, dtype=dtype)


def abstract_params(cfg: transformer.ArchConfig) -> dict:
    """The parameter tree as meta tensors (JAX's keys, shapes and dtypes;
    nothing drawn or allocated): the family's ``init_params`` run with
    ``layers.SHAPE_ONLY`` in place of a generator."""
    return get_module(cfg).init_params(layers.SHAPE_ONLY, cfg)


# --------------------------------------------------------------------------
# Input specs per (arch, shape): meta tensors only.
# --------------------------------------------------------------------------
def _sds(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: transformer.ArchConfig, shape: ShapeSpec) -> dict:
    """Abstract inputs for the step function selected by shape.kind.

    train:   {"batch": {"tokens","labels"} (+frames/patch_embeds stubs)}
    prefill: {"tokens"} (+stubs)
    decode:  {"tokens" (B,1), "cache": the family's cache of seq_len}
    """
    B, L = shape.global_batch, shape.seq_len
    mod = get_module(cfg)
    if shape.kind == "train":
        batch = {
            "tokens": _sds((B, L), torch.int32),
            "labels": _sds((B, L), torch.int32),
        }
        if cfg.family == "encdec":
            batch["frames"] = _sds((B, cfg.src_len, cfg.d_model), torch.bfloat16)
        if cfg.family == "vlm":
            batch["patch_embeds"] = _sds((B, cfg.n_patches, cfg.d_model), torch.bfloat16)
        return {"batch": batch}
    if shape.kind == "prefill":
        out: dict[str, Any] = {"tokens": _sds((B, L), torch.int32)}
        if cfg.family == "encdec":
            out["frames"] = _sds((B, cfg.src_len, cfg.d_model), torch.bfloat16)
        if cfg.family == "vlm":
            out["patch_embeds"] = _sds((B, cfg.n_patches, cfg.d_model), torch.bfloat16)
        return out
    # decode: abstract cache of size L
    return {"tokens": _sds((B, 1), torch.int32),
            "cache": mod.init_cache(cfg, B, L, device="meta")}


def runnable_cells(smoke: bool = False):
    """All (arch, shape) pairs the dry run covers (the 32 cells)."""
    cells = []
    for arch in ARCH_IDS:
        cfg = get_config(arch, smoke=smoke)
        for sname in SHAPES:
            if runnable(cfg.family, sname):
                cells.append((arch, sname))
    return cells
