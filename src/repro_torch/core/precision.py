"""Precision policies: which subsystem runs in which dtype.

Port of ``repro.core.precision``. NNPS runs in a low dtype (fp16),
integration, density and forces in fp32; the policy object keeps
precision explicit instead of ambient.
"""
from __future__ import annotations

import dataclasses

import torch

# Canonical dtype table, keyed by the names used throughout configs.
DTYPES = {
    "fp64": torch.float64,
    "fp32": torch.float32,
    "bf16": torch.bfloat16,
    "fp16": torch.float16,
}

# Canonical storage dtypes: NNPS_STORE is the fp16 cell-relative
# coordinate tier, HALF_STORE/BF16_STORE the two 16-bit record layouts
# of the force pass, HIGH_STORE the fp32 high tier.
NNPS_STORE = DTYPES["fp16"]
HALF_STORE = DTYPES["fp16"]
BF16_STORE = DTYPES["bf16"]
HIGH_STORE = DTYPES["fp32"]


def dtype_of(name: str) -> torch.dtype:
    try:
        return DTYPES[name]
    except KeyError:
        raise ValueError(f"unknown dtype name {name!r}; one of {sorted(DTYPES)}")


@dataclasses.dataclass(frozen=True)
class PrecisionPolicy:
    """Per-subsystem dtype assignment for the mixed-precision SPH step.

    nnps / coords: dtype of the neighbor-distance pipeline and of the
      stored cell-relative coordinates (paper: fp16).
    physics / accum: dtype of the density/momentum updates and sums.
    nnps_compute: arithmetic dtype of the Eq. (7) distance pipeline.
    records: storage dtype of the velocity/mass tiles of the force pass
      ("fp16"/"bf16" half-width layout, "fp32" the accuracy oracle).
    """

    nnps: str = "fp16"
    coords: str = "fp16"
    physics: str = "fp32"
    accum: str = "fp32"
    nnps_compute: str = "fp32"
    records: str = "fp16"

    @property
    def nnps_dtype(self) -> torch.dtype:
        return dtype_of(self.nnps)

    @property
    def nnps_compute_dtype(self) -> torch.dtype:
        return dtype_of(self.nnps_compute)

    @property
    def coords_dtype(self) -> torch.dtype:
        return dtype_of(self.coords)

    @property
    def physics_dtype(self) -> torch.dtype:
        return dtype_of(self.physics)

    @property
    def accum_dtype(self) -> torch.dtype:
        return dtype_of(self.accum)

    @property
    def records_dtype(self) -> torch.dtype:
        return dtype_of(self.records)

    @property
    def half_records(self) -> bool:
        """True when the force pass uses the 16-bit record layout."""
        return self.records_dtype.itemsize == 2

    def with_records(self, records: str) -> "PrecisionPolicy":
        """This policy with the record storage dtype replaced."""
        dtype_of(records)  # validate eagerly
        return dataclasses.replace(self, records=records)


# The paper's three experiment configurations (Table 4), fp64 -> fp32.
APPROACH_I = PrecisionPolicy(
    nnps="fp32", coords="fp32", physics="fp32", records="fp32"
)
APPROACH_II = PrecisionPolicy(nnps="fp16", coords="fp16", physics="fp32")
APPROACH_III = PrecisionPolicy(nnps="fp16", coords="fp16", physics="fp32")

# The full-width record layout: the exactness oracle of the force pass.
FP32_RECORDS = PrecisionPolicy(records="fp32")
