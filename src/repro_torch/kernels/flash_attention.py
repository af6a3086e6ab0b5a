"""K7: blocked (flash) causal GQA attention for prefill.

Replaces the Pallas kernel ``repro/kernels/flash_attention.py::
flash_attention`` with the hand-written CUDA kernel
``csrc/flash_attention.cu``: per query tile it walks the K/V tiles of the
query head's kv head (no repeated K/V), carries the online softmax in
fp32, skips tiles wholly above the causal diagonal, masks rows and
columns past the lengths (any L works) and gives 0 for a fully masked
row, as the TPU kernel's guard does. bf16 inputs take the tensor cores
(TMA loads, ``wgmma`` for S = Q Kᵀ and, with P split exactly into three
bf16 parts by :func:`split_bf16x3`, for O += P V); fp32 inputs take a
CUDA-core kernel. Its bound on the H100 is the causal product's
operations (see the source's note and PERF.md).

:func:`flash_attention` launches the kernel for CUDA tensors and takes
the plain version :func:`flash_attention_ref` (``kernels/ref.py::
ref_attention``'s math) only for CPU tensors. The two agree within
:func:`rounding_bound`. ``flash_attention.launches`` counts launches.
"""
from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from repro_torch.kernels import _build

NEG_INF = -1e30
_KIND = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (16, 32, 64, 128)
_BF16_ROWS = 128  # query rows per CTA of the bf16 kernel
_U32 = 2.0**-24  # fp32 unit roundoff


def _gqa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """K and V repeated to q's heads, all in fp32."""
    rep = q.shape[1] // k.shape[1]
    return (q.float(), k.float().repeat_interleave(rep, dim=1),
            v.float().repeat_interleave(rep, dim=1))


def causal_mask(lq: int, lk: int, device, shift: int = 0) -> torch.Tensor:
    """(Lq, Lk) bool: key j is seen by query i when j <= i + (Lk - Lq)."""
    return torch.ones((lq, lk), dtype=torch.bool, device=device).tril(lk - lq + shift)


def masked_softmax(s: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Softmax over the last axis of the valid entries; a row with none
    gives zeros (the kernels' guard; a plain softmax would average)."""
    s = torch.where(valid, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(s > NEG_INF / 2, torch.exp(s - m), 0.0)
    den = p.sum(dim=-1, keepdim=True)
    return p / torch.where(den > 0, den, 1.0)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, scale: float | None = None) -> torch.Tensor:
    """Plain PyTorch version of :func:`flash_attention`: q (B, H, Lq, Dh),
    k/v (B, Hkv, Lk, Dh) -> (B, H, Lq, Dh) f32, one softmax over the whole
    score matrix (``ref_attention``; a fully masked row gives 0)."""
    lq, dh = q.shape[2], q.shape[3]
    lk = k.shape[2]
    qf, kf, vf = _gqa(q, k, v)
    scale = scale if scale is not None else 1.0 / math.sqrt(dh)
    s = torch.einsum("bhqd,bhkd->bhqk", qf, kf) * scale
    valid = (causal_mask(lq, lk, q.device) if causal
             else torch.ones((lq, lk), dtype=torch.bool, device=q.device))
    return torch.einsum("bhqk,bhkd->bhqd", masked_softmax(s, valid), vf)


def split_bf16x3(p: torch.Tensor) -> tuple:
    """fp32 ``p`` as three bf16 parts, as the bf16 kernel feeds P to the
    tensor cores: hi = bf16(p), mid = bf16(p - hi), lo = bf16(p - hi - mid).
    Each subtraction is exact in fp32, so hi + mid + lo == p for |p| >=
    2^-110; below that lo leaves bf16's range and the sum is within
    2^-134 of p."""
    hi = p.to(torch.bfloat16)
    rest = p - hi.float()
    mid = rest.to(torch.bfloat16)
    return hi, mid, (rest - mid.float()).to(torch.bfloat16)


def rounding_bound(qf: torch.Tensor, kf: torch.Tensor, vf: torch.Tensor, valid: torch.Tensor,
                   scale: float, *, relative: bool = False) -> torch.Tensor:
    """Elementwise tolerance of two fp32 evaluations of attention that sum
    in different orders (K6 and K7 against their plain versions). For row
    i with weights p̂_j = softmax_j(s_ij):

      * each score s_ij carries at most E_i = (Dh + 2) u max_j scale Σ_d
        |q_id k_jd| of rounding, and the max shifts by as much, so each
        weight is off by a relative 2 E_i plus a few ulps of ``expf``;
      * out_i = Σ_j p̂_j v_j moves by at most that relative error times
        Σ_j p̂_j |v_j − out_i| <= A_i + |out_i|, A_i = Σ_j p̂_j |v_j|;
      * the n-term sums of p_j v_j and p_j (and the tile rescalings) add
        (n + 8) u of the same.

    bound = 4 (E_i + (n + 8) u) (A_i + |out_i|), with a factor 2 to spare.

    It covers the bf16 kernel's tensor-core sums as well: the products of
    bf16 values (q·k, and each bf16 part of p times v, the parts summing
    to p exactly, see :func:`split_bf16x3`) are exact, and ``wgmma`` adds
    them in fp32 in groups of 16 onto the accumulator, so a score takes
    Dh / 16 rounding steps and out_i 3 n / 16, each at most a few u of
    the running magnitude: fewer than the Dh and n sequential fp32 FMAs
    this bound allows for.
    Inputs: qf (B, H, Lq, Dh), kf/vf (B, H, Lk, Dh) f32 (GQA repeated),
    ``valid`` broadcastable to (B, H, Lq, Lk). Returns (B, H, Lq, Dh), or
    with ``relative`` the factor 4 (E_i + (n + 8) u) alone, (B, H, Lq, 1),
    which also bounds the relative error of the softmax denominator.
    """
    dh, n = qf.shape[-1], kf.shape[-2]
    sabs = torch.einsum("bhqd,bhkd->bhqk", qf.abs(), kf.abs()) * scale
    e = (dh + 2) * _U32 * torch.where(valid, sabs, 0.0).amax(dim=-1, keepdim=True)
    rel = 4.0 * (e + (n + 8) * _U32)
    if relative:
        return rel
    p = masked_softmax(torch.einsum("bhqd,bhkd->bhqk", qf, kf) * scale, valid)
    a = torch.einsum("bhqk,bhkd->bhqd", p, vf.abs())
    out = torch.einsum("bhqk,bhkd->bhqd", p, vf)
    return rel * (a + out.abs())


#: Limit on ‖kernel − plain‖₂ / ‖plain‖₂ of K6's and K7's outputs, beside
#: the elementwise bound (readings in PERF.md).
NORMWISE_LIMIT = 1e-5


def compare(name: str, out_k: torch.Tensor, out_r: torch.Tensor, bnd: torch.Tensor) -> dict:
    """Every element of ``out_k`` within ``bnd`` of ``out_r`` and the two
    within :data:`NORMWISE_LIMIT` normwise; raises AssertionError, returns
    ``max_abs_err``, ``max_ratio`` (error over bound) and ``normwise``."""
    if not bool(torch.isfinite(out_k).all()):
        raise AssertionError(f"{name}: non-finite values")
    err = (out_k - out_r).abs()
    ratio = float((err / bnd.clamp_min(1e-30)).max())
    normwise = float(torch.linalg.vector_norm(err)
                     / torch.linalg.vector_norm(out_r).clamp_min(1e-30))
    if ratio > 1.0 or normwise > NORMWISE_LIMIT:
        raise AssertionError(
            f"{name} disagrees with its plain version: max err/bound {ratio:.3g}, "
            f"normwise {normwise:.3g} (limit {NORMWISE_LIMIT:g})")
    return {"max_abs_err": float(err.max()) if err.numel() else 0.0, "max_ratio": ratio,
            "normwise": normwise}


def check_against_plain(args: tuple, kw: dict, out_k: torch.Tensor | None = None) -> dict:
    """Launch K7 (or take its output ``out_k``) and its plain version on
    the same inputs (CUDA tensors) and :func:`compare` them under
    :func:`rounding_bound`."""
    q, k, v = args
    causal = kw.get("causal", True)
    scale = kw.get("scale") or 1.0 / math.sqrt(q.shape[-1])
    if out_k is None:
        out_k = flash_attention(q, k, v, **kw)
    out_r = flash_attention_ref(q, k, v, **kw)
    lq, lk = q.shape[2], k.shape[2]
    valid = (causal_mask(lq, lk, q.device) if causal
             else torch.ones((lq, lk), dtype=torch.bool, device=q.device))
    return compare("K7", out_k, out_r, rounding_bound(*_gqa(q, k, v), valid, scale))


class FlashParams(ctypes.Structure):
    _fields_ = [("scale", ctypes.c_float), ("causal", ctypes.c_int),
                ("causal_shift", ctypes.c_int), ("p_hi_only", ctypes.c_int)]


def kernel_params(*, scale: float, causal: bool) -> FlashParams:
    """The kernel's run-time parameters; ``causal_shift`` and
    ``p_hi_only`` are 0 (:func:`planted_params` plants 1 without
    touching the source)."""
    return FlashParams(scale, int(causal), 0, 0)


#: The faults :func:`planted_params` plants.
FAULTS = ("causal_plus_one", "p_bf16")


def planted_params(fault: str):
    """A stand-in for :func:`kernel_params` with ``fault`` planted:
    ``causal_plus_one`` lets each query see one future key;
    ``p_bf16`` (bf16 inputs) feeds P to P·V as its bf16 hi part alone,
    rounding the fp32 weights once as FlashAttention does. A check rebinds
    ``kernel_params`` to it, and must then fail."""
    if fault not in FAULTS:
        raise ValueError(f"unknown fault {fault!r}, not in {FAULTS}")
    clean = kernel_params

    def faulty(**kw) -> FlashParams:
        p = clean(**kw)
        if fault == "causal_plus_one":
            p.causal_shift = 1
        else:
            p.p_hi_only = 1
        return p

    return faulty


def random_inputs(seed: int, b: int, h: int, hkv: int, lq: int, lk: int, dh: int,
                  dtype: torch.dtype, *, heads_last: bool = False, device="cpu") -> tuple:
    """The inputs of one K7 call, for the checks and tests: q (B, H, Lq,
    Dh) and k/v (B, Hkv, Lk, Dh), normal, in ``dtype``; ``heads_last``
    gives (B, L, heads, Dh) tensors viewed heads-major, as prefill passes."""
    rng = np.random.default_rng(seed)
    out = []
    for heads, n in ((h, lq), (hkv, lk), (hkv, lk)):
        x = torch.as_tensor(rng.normal(size=(b, n, heads, dh)).astype(np.float32),
                            device=device).to(dtype)
        out.append(x.transpose(1, 2) if heads_last else x.transpose(1, 2).contiguous())
    return tuple(out)


@functools.cache
def _entry():
    fn = _build.library().lib.repro_flash_attention
    fn.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
                   + [ctypes.c_void_p] * 3)
    fn.restype = ctypes.c_int
    return fn


def _check_qkv(q, k, v) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"q (B,H,Lq,Dh), k/v (B,Hkv,Lk,Dh): {q.shape}, {k.shape}, {v.shape}")
    b, h, _, dh = q.shape
    if k.shape[0] != b or k.shape[3] != dh or h % k.shape[1]:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} do not match")
    if q.dtype not in _KIND or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q, k, v must share fp32 or bf16, got {q.dtype}, {k.dtype}, {v.dtype}")
    if dh not in _HEAD_DIMS:
        raise ValueError(f"head dim {dh} not in {_HEAD_DIMS}")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("q, k and v need unit stride along the head dim")
    if b * h > 65535:
        raise ValueError(f"B*H = {b * h} exceeds the grid's y limit")
    if q.dtype == torch.bfloat16 and -(-q.shape[2] // _BF16_ROWS) > 65535:
        raise ValueError(f"Lq = {q.shape[2]} exceeds the bf16 kernel's grid y limit")


def _strides(t: torch.Tensor) -> list:
    """(b, head, l) element strides; a size-1 dim's stride (its index is
    always 0) reads as 8, which TMA takes."""
    return [s if n > 1 else 8 for s, n in zip(t.stride()[:3], t.shape[:3])]


def tma_addressable(t: torch.Tensor) -> bool:
    """Whether TMA reads the bf16 view ``t`` in place: a 16-byte aligned
    base and (b, head, l) strides that are positive multiples of 16 bytes.
    The wrapper copies any other view before the launch."""
    return t.data_ptr() % 16 == 0 and all(s > 0 and s % 8 == 0 for s in _strides(t))


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True,
                    scale: float | None = None) -> torch.Tensor:
    """Attention of q (B, H, Lq, Dh) over k/v (B, Hkv, Lk, Dh) (fp32 or
    bf16, any strides with a unit head-dim stride) -> (B, H, Lq, Dh) f32.
    A bf16 view that TMA cannot read in place (:func:`tma_addressable`)
    is copied first.

    CPU tensors take :func:`flash_attention_ref`; CUDA tensors launch the
    kernel or raise.
    """
    dev = q.device
    if dev.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, scale=scale)
    if dev.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu tensors, got {dev}")
    if k.device != dev or v.device != dev:
        raise ValueError("q, k and v must be on one device")
    _check_qkv(q, k, v)
    if q.dtype == torch.bfloat16:
        q, k, v = (t if tma_addressable(t) else t.clone(memory_format=torch.contiguous_format)
                   for t in (q, k, v))
    b, h, lq, dh = q.shape
    hkv, lk = k.shape[1], k.shape[2]
    scale = float(scale if scale is not None else 1.0 / math.sqrt(dh))
    out = torch.empty((b, h, lq, dh), dtype=torch.float32, device=dev)
    strides = (ctypes.c_longlong * 9)(*(s for t in (q, k, v) for s in _strides(t)))
    params = kernel_params(scale=scale, causal=causal)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _entry()(_KIND[q.dtype], dh, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                      out.data_ptr(), b, h, hkv, lq, lk, ctypes.addressof(strides),
                      ctypes.addressof(params), stream)
    _build.check_rc(rc, "flash_attention")
    _WRAPPER.launches += 1
    return out


flash_attention.launches = 0
# The counter lives on this function object even if the module attribute
# is rebound (e.g. by a harness that wraps the wrapper).
_WRAPPER = flash_attention
