"""Architecture registry: --arch <id> -> config and module entry points.

Port of ``repro.models.registry`` for the architectures the port runs.
Every id of the JAX package is listed; one that is not ported raises
and names its ROADMAP item. (JAX's abstract parameter and input specs
serve its dry-run, which is not ported: ROADMAP Queue 1 item 10b.)
"""
from __future__ import annotations

import torch

from repro_torch.configs import llama3_2_3b
from repro_torch.models import transformer

ARCH_MODULES = {
    "granite-3-8b": "repro_torch.configs.granite_3_8b",
    "stablelm-1.6b": "repro_torch.configs.stablelm_1_6b",
    "internlm2-20b": "repro_torch.configs.internlm2_20b",
    "llama3.2-3b": "repro_torch.configs.llama3_2_3b",
    "deepseek-v2-236b": "repro_torch.configs.deepseek_v2_236b",
    "deepseek-moe-16b": "repro_torch.configs.deepseek_moe_16b",
    "whisper-large-v3": "repro_torch.configs.whisper_large_v3",
    "zamba2-1.2b": "repro_torch.configs.zamba2_1_2b",
    "pixtral-12b": "repro_torch.configs.pixtral_12b",
    "mamba2-130m": "repro_torch.configs.mamba2_130m",
}

ARCH_IDS = list(ARCH_MODULES)

#: The config modules the port has, by arch id.
PORTED = {"llama3.2-3b": llama3_2_3b}


def get_config(arch: str, smoke: bool = False) -> transformer.ArchConfig:
    if arch not in ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {ARCH_IDS}")
    if arch not in PORTED:
        raise NotImplementedError(
            f"{arch} is not ported ({ARCH_MODULES[arch]} does not exist yet): "
            f"{transformer.UNPORTED_ITEM}")
    mod = PORTED[arch]
    return mod.SMOKE if smoke else mod.CONFIG


def get_module(cfg: transformer.ArchConfig):
    """The model module implementing this family's entry points."""
    if cfg.family in transformer.UNPORTED_FAMILIES:
        raise NotImplementedError(f"family {cfg.family!r} is not ported: "
                                  f"{transformer.UNPORTED_ITEM}")
    return transformer


def init_params(gen: torch.Generator, cfg: transformer.ArchConfig) -> dict:
    return get_module(cfg).init_params(gen, cfg)
