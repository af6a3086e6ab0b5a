"""Serving driver: batched prefill + decode loop with either the dense
bf16 KV cache or the paper-technique RCLL-KV (block-anchored quantized)
cache. Reports tokens/s and cache bytes.

Port of ``repro.launch.serve``, for every architecture of the registry.
Prefill attention runs the K7 kernel and anchored decode attention the K6
kernel on the GPU (``models.attention``); MLA and the SSM mixers are
plain torch, as they are plain jnp in JAX.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-3b \\
      --batch 4 --prompt-len 1024 --gen 160 --kv-mode anchored
  PYTHONPATH=src python -m repro_torch.launch.serve --arch deepseek-moe-16b \\
      --batch 4 --prompt-len 1024 --gen 160 --kv-mode anchored
  PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.core.solver import resolve_device
from repro_torch.models import layers, registry, transformer


def cache_leaves(cache):
    """The tensors of a cache, nested NamedTuples walked in field order."""
    if isinstance(cache, torch.Tensor):
        yield cache
    else:
        for field in cache:
            yield from cache_leaves(field)


def cache_clone(cache):
    """A copy of a (nested) cache that owns its storage."""
    if isinstance(cache, torch.Tensor):
        return cache.clone()
    return type(cache)(*(cache_clone(field) for field in cache))


def cache_bytes(cache) -> int:
    return sum(t.numel() * t.element_size() for t in cache_leaves(cache))


def modality_inputs(cfg, batch: int, device) -> dict:
    """The modality frontends' stubs, as JAX's ServeRun makes them: encdec
    frames (B, src_len, d_model) and vlm patch embeddings (B, n_patches,
    d_model), bf16 standard normals from generators seeded 7 and 8 on
    ``device`` (JAX draws from ``jax.random.key(7/8)``: other numbers)."""
    def normal(seed, rows):
        gen = torch.Generator(device=device).manual_seed(seed)
        return torch.randn((batch, rows, cfg.d_model), generator=gen, device=device,
                           dtype=torch.bfloat16)

    if cfg.family == "encdec":
        return {"frames": normal(7, cfg.src_len)}
    if cfg.family == "vlm":
        return {"patch_embeds": normal(8, cfg.n_patches)}
    return {}


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


@dataclasses.dataclass
class ServeRun:
    arch: str
    smoke: bool = True
    batch: int = 4
    prompt_len: int = 64
    gen: int = 32
    max_len: int = 0  # 0 -> prompt_len + gen (rounded to kv_block)
    kv_mode: str = "dense"  # dense | anchored
    # 0 keeps the config's depth; n > 0 serves its first n layers at the
    # published widths (a model too deep for one card)
    n_layers: int = 0
    seed: int = 0
    greedy: bool = True
    device: str | torch.device | None = None  # None -> CUDA (raises without it)
    # Weights to serve (the family module's parameter dict, e.g. carried
    # from JAX by ``core.interop.lm_params_from_numpy``); None draws them
    # from seed, in bf16 as drawn.
    params: dict | None = None
    # The modality stubs (``frames`` / ``patch_embeds``, e.g. JAX's); None
    # makes them with :func:`modality_inputs`.
    inputs: dict | None = None

    def run(self) -> dict:
        dev = resolve_device(self.device)
        cfg = registry.get_config(self.arch, smoke=self.smoke)
        cfg = dataclasses.replace(cfg, kv_mode=self.kv_mode,
                                  n_layers=self.n_layers or cfg.n_layers)
        mod = registry.get_module(cfg)
        rng = np.random.default_rng(self.seed)
        max_len = self.max_len or self.prompt_len + self.gen
        if cfg.kv_mode == "anchored":
            max_len = -(-max_len // cfg.kv_block) * cfg.kv_block
        tokens = torch.as_tensor(rng.integers(0, cfg.vocab, (self.batch, self.prompt_len)),
                                 dtype=torch.int32, device=dev)
        with torch.inference_mode():
            if self.params is None:  # drawn in the compute dtype, one fp32 layer at a time
                weights = mod.init_params(torch.Generator(device=dev).manual_seed(self.seed),
                                          cfg, dtype=layers.DEFAULT_COMPUTE)
            else:  # one bf16 copy of the given weights (none if they are bf16 already)
                weights = transformer.compute_weights(self.params)
            kw = (modality_inputs(cfg, self.batch, dev) if self.inputs is None
                  else {k: v.to(dev) for k, v in self.inputs.items()})

            _sync(dev)
            t0 = time.perf_counter()
            lg, cache = mod.prefill(weights, tokens, cfg, max_len, **kw)
            _sync(dev)
            t_prefill = time.perf_counter() - t0

            cur = torch.argmax(lg[:, -1:], dim=-1).to(torch.int32)
            out_tokens = [cur]
            # warm up decode off the clock, on a copy: decode_step writes the
            # cache in place
            mod.decode_step(weights, cur, cache_clone(cache), cfg)
            _sync(dev)
            t1 = time.perf_counter()
            for _ in range(self.gen - 1):
                lg2, cache = mod.decode_step(weights, cur, cache, cfg)
                cur = torch.argmax(lg2, dim=-1).to(torch.int32)
                out_tokens.append(cur)
            _sync(dev)
            t_decode = time.perf_counter() - t1
        return {
            "tokens": torch.cat(out_tokens, dim=1).cpu().numpy(),
            "t_prefill_s": t_prefill,
            "t_decode_s": t_decode,
            "decode_tok_s": self.batch * (self.gen - 1) / max(t_decode, 1e-9),
            "cache_bytes": cache_bytes(cache),
            "kv_mode": cfg.kv_mode,
        }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-3b", choices=registry.ARCH_IDS)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--kv-mode", default="dense", choices=["dense", "anchored"])
    ap.add_argument("--device", default=None, help="default: cuda (raises without a GPU)")
    args = ap.parse_args()
    run = ServeRun(arch=args.arch, smoke=args.smoke, batch=args.batch,
                   prompt_len=args.prompt_len, gen=args.gen, kv_mode=args.kv_mode,
                   device=args.device)
    out = run.run()
    print(f"[serve] {args.arch} kv={out['kv_mode']} "
          f"prefill {out['t_prefill_s']*1e3:.0f}ms "
          f"decode {out['decode_tok_s']:.1f} tok/s "
          f"cache {out['cache_bytes']/2**20:.1f} MiB")


if __name__ == "__main__":
    main()
