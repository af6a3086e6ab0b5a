"""Assigned input shapes (the 4 cells every architecture is paired with).

Port of ``repro.configs.shapes``. ``decode_*`` / ``long_*`` run
``decode_step`` (one new token against a KV cache of seq_len), not a
train step. long_500k requires sub-quadratic sequence mixing: it runs
for the ssm/hybrid families only.
"""
import dataclasses


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}

# families allowed to run long_500k (sub-quadratic sequence mixing)
LONG_OK_FAMILIES = ("ssm", "hybrid")


def runnable(family: str, shape: str) -> bool:
    if shape == "long_500k":
        return family in LONG_OK_FAMILIES
    return True
