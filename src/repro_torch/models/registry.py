"""Architecture registry: --arch <id> -> config and module entry points.

Port of ``repro.models.registry``: every id of the JAX package, its
config module and its family's module. (JAX's abstract parameter and
input specs serve its dry run, which is not ported: ROADMAP Queue 1.)
"""
from __future__ import annotations

import torch

from repro_torch.configs import (deepseek_moe_16b, deepseek_v2_236b, granite_3_8b,
                                 internlm2_20b, llama3_2_3b, mamba2_130m, pixtral_12b,
                                 stablelm_1_6b, whisper_large_v3, zamba2_1_2b)
from repro_torch.models import encdec, hybrid, transformer

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
