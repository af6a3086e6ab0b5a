"""Counts the FLOPs each rank does in one SMOKE training step on a (2, 2)
("data", "model") mesh of four gloo ranks on the CPU, beside the same step
without a mesh, for each model id given (``tests/sharding_ranks.py``'s
``case_flops``: ``torch.utils.flop_counter``'s formulas over the ops each
rank runs on its local tensors, by aten op; elementwise ops count none).

A step split perfectly over the four ranks would read 0.25 of the run
without a mesh. What the port repeats reads above it: the row-parallel
products (``partitioning.row_parallel``) split over "data" only, and the
steps run on whole copies (``partitioning.on_replicas``: MoE routing,
dispatch and combine) not at all.

Run from the repo root (torch only, no card):

    PYTHONPATH=src python tools/mesh_flops.py [--archs llama3.2-3b ...] \\
        [--batch 4] [--seq 32] [--out chiprun_out/mesh_flops.json]
"""
from __future__ import annotations

import argparse
import json
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "tests"))

import sharding_ranks  # noqa: E402

ARCHS = ("llama3.2-3b", "internlm2-20b", "pixtral-12b", "mamba2-130m", "zamba2-1.2b",
         "whisper-large-v3", "deepseek-moe-16b", "deepseek-v2-236b")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--archs", nargs="+", default=list(ARCHS))
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=32)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    run = dict(smoke=True, batch=args.batch, seq=args.seq)
    with tempfile.TemporaryDirectory() as work:
        ranks = sharding_ranks.launch(work, 4, timeout=600,
                                      flops=dict(archs=args.archs, run=run))
    out = {}
    for arch in args.archs:
        per_rank = [sum(r["flops"][arch][0].values()) for r in ranks]
        plain = sum(ranks[0]["flops"][arch][1].values())
        out[arch] = {"plain": plain, "per_rank": per_rank, "share": max(per_rank) / plain,
                     "by_op": ranks[0]["flops"][arch]}
        print(f"{arch:18s} no mesh {plain:>12,d}  (2, 2) per rank "
              f"{', '.join(f'{n:,d}' for n in per_rank)}  share {max(per_rank) / plain:.4f}")
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps({"run": run, "archs": out}, indent=1))
    return out


if __name__ == "__main__":
    main()
