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

Training (K7b): where an input needs a gradient, :func:`flash_attention`
is the autograd op :class:`Attention`. Its forward launches K7 with each
row's logsumexp as a second output; its backward launches the hand-written
gradient :func:`flash_attention_bwd` (``csrc/flash_attention_bwd.cu``),
the counterpart of XLA's autodiff of JAX's plain ``sdpa_chunked``, held to
:func:`flash_attention_bwd_ref` within :func:`rounding_bound_bwd`. Its
bf16 path runs on the tensor cores with dO, P and dS split exactly into
three bf16 parts; :func:`flash_attention_bwd_split_ref` mirrors that
scheme in plain torch.
"""
from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from repro_torch.kernels import _build, cost

NEG_INF = -1e30
_KIND = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (16, 32, 64, 128)
_BF16_ROWS = 128  # query rows per CTA of the bf16 kernel (K7, and K7b's dQ kernel)
_BWD_KEYS = 64  # keys per CTA of K7b's bf16 dK/dV kernel; lse and D rows padded to it
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
    fn.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                   + [ctypes.c_void_p] * 3)
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _bwd_entry():
    fn = _build.library().lib.repro_flash_attention_bwd
    fn.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 10 + [ctypes.c_int] * 5
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


def _needs_grad(*ts) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def k7_cost(q, k, v, causal: bool, with_lse: bool) -> tuple:
    """(FLOPs, bytes, on the tensor cores) of one K7 call, for the dry
    run's counter (``kernels.cost``): 4 Dh FLOPs a visible (query, key)
    pair (q.k and p.v), q, k, v read once, out (and lse) written once in
    fp32. bf16 inputs run on the tensor cores."""
    b, h, lq, dh = q.shape
    pairs = cost.visible_pairs(lq, k.shape[2], causal)
    nbytes = ((q.numel() + k.numel() + v.numel()) * q.element_size()
              + b * h * lq * (dh + (1 if with_lse else 0)) * 4)
    return 4 * dh * b * h * pairs, nbytes, q.dtype == torch.bfloat16


def _forward(q, k, v, causal: bool, scale: float | None, with_lse: bool):
    """One K7 call on q's device, counted as one under the dry run's
    counter: the launch on CUDA tensors, the plain versions on CPU
    tensors, empty outputs of the right shapes and dtypes on meta tensors
    (never on CUDA ones). Returns (out, lse or None, the q, k, v it read)."""
    def run(q, k, v):
        if q.device.type == "cpu":
            lse = lse_ref(q, k, causal=causal, scale=scale) if with_lse else None
            return flash_attention_ref(q, k, v, causal=causal, scale=scale), lse, (q, k, v)
        if q.device.type == "meta":
            _check_qkv(q, k, v)
            b, h, lq, dh = q.shape
            lse = q.new_empty((b, h, lq), dtype=torch.float32) if with_lse else None
            return q.new_empty((b, h, lq, dh), dtype=torch.float32), lse, (q, k, v)
        return _launch(q, k, v, causal, scale, with_lse)

    return cost.kernel("flash_attention", lambda q, k, v: k7_cost(q, k, v, causal, with_lse),
                       run, (q, k, v))


def _no_dtensor(*ts) -> None:
    """A DTensor's data pointer is not its shard's: the kernels take each
    rank's plain local tensors (``models.attention.sharded_attention``)."""
    from torch.distributed.tensor import DTensor

    if any(isinstance(t, DTensor) for t in ts):
        raise TypeError("K7 and K7b take plain tensors: call them on a DTensor's local shard "
                        "(models.attention.sharded_attention)")


def _launch(q, k, v, causal: bool, scale: float | None, with_lse: bool):
    """Launch K7 on CUDA tensors: (out, lse or None, the q, k, v it read)."""
    _no_dtensor(q, k, v)
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda, cpu or meta tensors, got {dev}")
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
    lse = torch.empty((b, h, lq), dtype=torch.float32, device=dev) if with_lse else None
    strides = (ctypes.c_longlong * 9)(*(s for t in (q, k, v) for s in _strides(t)))
    params = kernel_params(scale=scale, causal=causal)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _entry()(_KIND[q.dtype], dh, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                      out.data_ptr(), lse.data_ptr() if with_lse else None, b, h, hkv, lq, lk,
                      ctypes.addressof(strides), ctypes.addressof(params), stream)
    _build.check_rc(rc, "flash_attention")
    _WRAPPER.launches += 1
    return out, lse, (q, k, v)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True,
                    scale: float | None = None) -> torch.Tensor:
    """Attention of q (B, H, Lq, Dh) over k/v (B, Hkv, Lk, Dh) (fp32 or
    bf16, any strides with a unit head-dim stride) -> (B, H, Lq, Dh) f32.
    A bf16 view that TMA cannot read in place (:func:`tma_addressable`)
    is copied first.

    CPU tensors take :func:`flash_attention_ref`; CUDA tensors launch the
    kernel or raise; meta tensors (the dry run) give an empty output of
    the right shape. Where an input needs a gradient, the call is an
    autograd op (:class:`Attention`): K7 also writes each row's
    logsumexp, and the backward launches K7b (:func:`flash_attention_bwd`);
    on CPU tensors the plain forward and :func:`flash_attention_bwd_ref`.
    Otherwise (serving) the launch writes no logsumexp. Under the dry
    run's counter a call counts :func:`k7_cost`.
    """
    if _needs_grad(q, k, v):
        return Attention.apply(q, k, v, causal, scale, False)
    return _forward(q, k, v, causal, scale, with_lse=False)[0]


flash_attention.launches = 0
# The counter lives on this function object even if the module attribute
# is rebound (e.g. by a harness that wraps the wrapper).
_WRAPPER = flash_attention


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                          causal: bool = True, scale: float | None = None) -> torch.Tensor:
    """:func:`flash_attention` through its plain versions on any device:
    the plain forward and, where an input needs a gradient,
    :func:`flash_attention_bwd_ref` (a check's plain path on the card)."""
    if _needs_grad(q, k, v):
        return Attention.apply(q, k, v, causal, scale, True)
    return flash_attention_ref(q, k, v, causal=causal, scale=scale)


class Attention(torch.autograd.Function):
    """K7 and its gradient as one autograd op. The forward keeps the
    tensors the kernel read (a bf16 view TMA cannot address is copied by
    the launch), its output and each row's logsumexp; the backward hands
    them and dO to K7b's wrapper, and casts dq, dk, dv (fp32) to q's, k's
    and v's dtypes. On CPU tensors the forward is the plain version (and
    the wrapper takes its plain version), on meta tensors (the dry run)
    both give empty outputs; ``plain`` takes both plain versions on any
    device."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, scale: float | None, plain: bool):
        scale = float(scale if scale is not None else 1.0 / math.sqrt(q.shape[-1]))
        if plain:
            out = flash_attention_ref(q, k, v, causal=causal, scale=scale)
            lse, read = lse_ref(q, k, causal=causal, scale=scale), (q, k, v)
        else:
            out, lse, read = _forward(q, k, v, causal, scale, with_lse=True)
        ctx.save_for_backward(*read, out, lse)
        ctx.causal, ctx.scale, ctx.plain = causal, scale, plain
        ctx.dtypes = (q.dtype, k.dtype, v.dtype)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        bwd = flash_attention_bwd_ref if ctx.plain else flash_attention_bwd
        grads = bwd(q, k, v, out, lse, dout, causal=ctx.causal, scale=ctx.scale)
        return (*(g.to(dt) for g, dt in zip(grads, ctx.dtypes)), None, None, None)


# --------------------------------------------------------------------------
# K7b: the backward pass
# --------------------------------------------------------------------------
def lse_ref(q: torch.Tensor, k: torch.Tensor, *, causal: bool = True,
            scale: float | None = None) -> torch.Tensor:
    """Each row's logsumexp of its scaled, masked scores (B, H, Lq) f32, as
    K7 writes it: +inf for a row that sees no key."""
    lq, lk, dh = q.shape[2], k.shape[2], q.shape[3]
    rep = q.shape[1] // k.shape[1]
    scale = scale if scale is not None else 1.0 / math.sqrt(dh)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(),
                     k.float().repeat_interleave(rep, dim=1)) * scale
    valid = _valid(lq, lk, causal, q.device)
    lse = torch.logsumexp(torch.where(valid, s, -math.inf), dim=-1)
    return torch.where(valid.any(dim=-1), lse, math.inf)


def _valid(lq: int, lk: int, causal: bool, device, shift: int = 0) -> torch.Tensor:
    return (causal_mask(lq, lk, device, shift) if causal
            else torch.ones((lq, lk), dtype=torch.bool, device=device))


def _group_sum(x: torch.Tensor, hkv: int) -> torch.Tensor:
    """(B, H, L, Dh) -> (B, Hkv, L, Dh): the sum over each kv head's rep
    query heads, in head order."""
    b, h = x.shape[:2]
    return x.reshape(b, hkv, h // hkv, *x.shape[2:]).sum(dim=2)


def flash_attention_bwd_ref(q, k, v, out, lse, dout, *, causal: bool = True,
                            scale: float | None = None) -> tuple:
    """Plain PyTorch version of :func:`flash_attention_bwd`: (dq, dk, dv)
    f32 from K7's inputs, its output ``out`` and logsumexp ``lse``
    (:func:`lse_ref`) and dO, by the formulas of the kernel's source:
    D = rowsum(dO o), P = exp(scale q k^T - lse) on the visible pairs,
    dV = P^T dO, dS = P (dO v^T - D), dQ = scale dS k, dK = scale dS^T q,
    dK and dV summed over each kv head's query heads."""
    lq, lk, dh = q.shape[2], k.shape[2], q.shape[3]
    hkv = k.shape[1]
    scale = scale if scale is not None else 1.0 / math.sqrt(dh)
    qf, kf, vf = _gqa(q, k, v)
    do, of = dout.float(), out.float()
    s = torch.einsum("bhqd,bhkd->bhqk", qf, kf) * scale
    p = torch.where(_valid(lq, lk, causal, q.device), torch.exp(s - lse[..., None]), 0.0)
    d = (do * of).sum(dim=-1)
    ds = p * (torch.einsum("bhqd,bhkd->bhqk", do, vf) - d[..., None])
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kf) * scale
    dk = _group_sum(torch.einsum("bhqk,bhqd->bhkd", ds, qf) * scale, hkv)
    dv = _group_sum(torch.einsum("bhqk,bhqd->bhkd", p, do), hkv)
    return dq, dk, dv


class BwdParams(ctypes.Structure):
    _fields_ = [("scale", ctypes.c_float), ("causal", ctypes.c_int),
                ("causal_shift", ctypes.c_int), ("first_head_only", ctypes.c_int),
                ("d_from_do", ctypes.c_int), ("ds_hi_only", ctypes.c_int)]


def backward_params(*, scale: float, causal: bool) -> BwdParams:
    """K7b's run-time parameters; the fault switches are 0
    (:func:`planted_backward_params` plants them)."""
    return BwdParams(scale, int(causal), 0, 0, 0, 0)


#: The faults :func:`planted_backward_params` plants in K7b.
BACKWARD_FAULTS = ("gqa_first_head", "causal_plus_one", "d_from_do", "ds_hi_only")


def planted_backward_params(fault: str):
    """A stand-in for :func:`backward_params` with ``fault`` planted:
    ``gqa_first_head``: dK and dV take only the first query head of each
    kv head's group; ``causal_plus_one``: the backward's causal mask lets
    each query see one future key; ``d_from_do``: D_i = sum_d dO_id, O
    left out; ``ds_hi_only`` (bf16 inputs): dQ and dK take dS's bf16 hi
    part alone, as a bf16 FlashAttention backward rounds it. A check
    rebinds ``backward_params`` to it, and must then fail."""
    if fault not in BACKWARD_FAULTS:
        raise ValueError(f"unknown fault {fault!r}, not in {BACKWARD_FAULTS}")
    clean = backward_params

    def faulty(**kw) -> BwdParams:
        p = clean(**kw)
        setattr(p, {"gqa_first_head": "first_head_only", "causal_plus_one": "causal_shift",
                    "d_from_do": "d_from_do", "ds_hi_only": "ds_hi_only"}[fault], 1)
        return p

    return faulty


def flash_attention_bwd(q, k, v, out, lse, dout, *, causal: bool = True,
                        scale: float | None = None) -> tuple:
    """K7b: (dq (B, H, Lq, Dh), dk, dv (B, Hkv, Lk, Dh)) f32, the gradient
    of :func:`flash_attention` at q, k, v (K7's inputs as it read them,
    fp32 or bf16, unit head-dim stride), its output ``out`` (B, H, Lq,
    Dh) f32, each row's logsumexp ``lse`` (B, H, Lq) f32 (K7's, or
    :func:`lse_ref`; +inf where a row sees no key) and dO.

    CPU tensors take :func:`flash_attention_bwd_ref`; CUDA tensors launch
    the kernels of ``csrc/flash_attention_bwd.cu`` or raise: for bf16 the
    tensor-core path (D and dO's split, dQ, dK and dV; a view TMA cannot
    read in place, :func:`tma_addressable`, is copied first), for fp32
    the CUDA-core kernels (D and dQ, dK and dV). Meta tensors (the dry
    run) give empty gradients of the right shapes. Under the dry run's
    counter a call counts :func:`k7b_cost`.
    ``flash_attention_bwd.launches`` counts calls.
    """
    def run(q, k, v, out, lse, dout):
        if q.device.type == "cpu":
            return flash_attention_bwd_ref(q, k, v, out, lse, dout, causal=causal, scale=scale)
        if q.device.type == "meta":
            _check_qkv(q, k, v)
            return tuple(t.new_empty(t.shape, dtype=torch.float32) for t in (q, k, v))
        return _bwd_launch(q, k, v, out, lse, dout, causal, scale)

    return cost.kernel("flash_attention_bwd", lambda q, k, v, *_: k7b_cost(q, k, v, causal),
                       run, (q, k, v, out, lse, dout))


def k7b_cost(q, k, v, causal: bool) -> tuple:
    """(FLOPs, bytes, on the tensor cores) of one K7b call, for the dry
    run's counter: 10 Dh FLOPs a visible pair (q.k, dO.v, P dO, dS k,
    dS q), q, k, v, O, dO and lse read once, D and dq, dk, dv (fp32)
    written once."""
    b, h, lq, dh = q.shape
    pairs = cost.visible_pairs(lq, k.shape[2], causal)
    nbytes = ((q.numel() + k.numel() + v.numel()) * q.element_size()
              + (2 * q.numel() + 2 * b * h * lq + q.numel() + k.numel() + v.numel()) * 4)
    return 10 * dh * b * h * pairs, nbytes, q.dtype == torch.bfloat16


def _bwd_launch(q, k, v, out, lse, dout, causal: bool, scale: float | None) -> tuple:
    """Launch K7b's kernels on CUDA tensors: (dq, dk, dv) f32."""
    _no_dtensor(q, k, v, out, lse, dout)
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"flash_attention_bwd runs on cuda, cpu or meta tensors, got {dev}")
    if any(t.device != dev for t in (k, v, out, lse, dout)):
        raise ValueError("q, k, v, out, lse and dout must be on one device")
    _check_qkv(q, k, v)
    b, h, lq, dh = q.shape
    hkv, lk = k.shape[1], k.shape[2]
    if lq == 0 or lk == 0:
        raise ValueError(f"flash_attention_bwd needs Lq, Lk >= 1, got {lq}, {lk}")
    if out.shape != q.shape or dout.shape != q.shape or lse.shape != (b, h, lq):
        raise ValueError(f"out {tuple(out.shape)}, dout {tuple(dout.shape)}, lse "
                         f"{tuple(lse.shape)} do not match q {tuple(q.shape)}")
    if q.dtype == torch.bfloat16:
        if -(-lk // _BWD_KEYS) > 65535:
            raise ValueError(f"Lk = {lk} exceeds the bf16 backward's grid y limit")
        q, k, v = (t if tma_addressable(t) else t.clone(memory_format=torch.contiguous_format)
                   for t in (q, k, v))
    scale = float(scale if scale is not None else 1.0 / math.sqrt(dh))
    out, dout, lse = (t.float().contiguous() for t in (out, dout, lse))
    scratch = torch.empty(_bwd_scratch_words(q.dtype, b, h, lq, dh), dtype=torch.float32,
                          device=dev)
    dq = torch.empty((b, h, lq, dh), dtype=torch.float32, device=dev)
    dk = torch.empty((b, hkv, lk, dh), dtype=torch.float32, device=dev)
    dv = torch.empty_like(dk)
    strides = (ctypes.c_longlong * 9)(*(s for t in (q, k, v) for s in _strides(t)))
    params = backward_params(scale=scale, causal=causal)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _bwd_entry()(_KIND[q.dtype], dh, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                          out.data_ptr(), dout.data_ptr(), lse.data_ptr(), scratch.data_ptr(),
                          dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, h, hkv, lq, lk,
                          ctypes.addressof(strides), ctypes.addressof(params), stream)
    _build.check_rc(rc, "flash_attention_bwd")
    _BWD_WRAPPER.launches += 1
    return dq, dk, dv


flash_attention_bwd.launches = 0
_BWD_WRAPPER = flash_attention_bwd


def _bwd_scratch_words(dtype: torch.dtype, b: int, h: int, lq: int, dh: int) -> int:
    """fp32 words of K7b's scratch: D (B, H, Lq) for fp32 inputs; for bf16
    the padded lse and D (2, B, H, Lpad), Lpad = Lq rounded up to
    ``_BWD_KEYS``, then dO's three bf16 planes (3, B, H, Lq, Dh)."""
    if dtype == torch.float32:
        return b * h * lq
    lpad = -(-lq // _BWD_KEYS) * _BWD_KEYS
    return 2 * b * h * lpad + 3 * b * h * lq * dh // 2


def flash_attention_bwd_split_ref(q, k, v, out, lse, dout, *, causal: bool = True,
                                  scale: float | None = None,
                                  ds_hi_only: bool = False) -> tuple:
    """Plain mirror of K7b's tensor-core scheme for bf16 q, k, v: the
    formulas of :func:`flash_attention_bwd_ref`, with every operand that is
    not bf16 already fed as its exact three-part bf16 split
    (:func:`split_bf16x3`) and each product of parts summed in fp32: dP =
    Σ_p dO_p vᵀ; dV = P dO over the six cross terms of P's and dO's parts
    down to 2^-24 (hi·hi, hi·mid, mid·hi, hi·lo, mid·mid, lo·hi); dQ and
    dK over dS's three parts (its hi part alone with ``ds_hi_only``, the
    planted fault). It models the split, not ``wgmma``'s order of
    accumulation."""
    lq, lk, dh = q.shape[2], k.shape[2], q.shape[3]
    hkv = k.shape[1]
    scale = scale if scale is not None else 1.0 / math.sqrt(dh)
    qf, kf, vf = _gqa(q, k, v)
    do, of = dout.float(), out.float()

    def parts(x):
        return [t.float() for t in split_bf16x3(x)]

    s = torch.einsum("bhqd,bhkd->bhqk", qf, kf) * scale
    p = torch.where(_valid(lq, lk, causal, q.device), torch.exp(s - lse[..., None]), 0.0)
    d = (do * of).sum(dim=-1)
    do3 = parts(do)
    dp = sum(torch.einsum("bhqd,bhkd->bhqk", x, vf) for x in do3)
    ds = p * (dp - d[..., None])
    p3, ds3 = parts(p), parts(ds)
    if ds_hi_only:
        ds3 = ds3[:1]
    dq = sum(torch.einsum("bhqk,bhkd->bhqd", x, kf) for x in ds3) * scale
    dk = sum(torch.einsum("bhqk,bhqd->bhkd", x, qf) for x in ds3) * scale
    dv = sum(torch.einsum("bhqk,bhqd->bhkd", p3[i], do3[j])
             for i, j in ((0, 0), (0, 1), (1, 0), (0, 2), (1, 1), (2, 0)))
    return dq, _group_sum(dk, hkv), _group_sum(dv, hkv)


def rounding_bound_bwd(q, k, v, out, lse, dout, *, causal: bool = True,
                       scale: float | None = None) -> tuple:
    """Elementwise tolerances (dq, dk, dv) of two fp32 evaluations of the
    backward from the same inputs that sum in different orders (K7b
    against :func:`flash_attention_bwd_ref`), u = 2^-24:

      * a score s_ij = scale q_i.k_j carries at most (Dh + 2) u S_ij of
        rounding, S_ij = scale sum_d |q_id k_jd|; with the subtraction of
        lse_i and ``expf`` (a few ulps), P_ij has the relative error
        rho_ij = (Dh + 2) u S_ij + (|s_ij| + |lse_i| + 4) u;
      * D_i and dp_ij = dO_i.v_j carry (Dh + 2) u of their absolute sums,
        so dS_ij = P_ij (dp_ij - D_i) is off by at most
        e_ij = P_ij (rho_ij |dp_ij - D_i| + (Dh + 2) u (sum_d |dO_id v_jd|
        + sum_d |dO_id o_id|) + 2 u |dp_ij - D_i|);
      * dQ_i = scale sum_j dS_ij k_j moves by scale sum_j e_ij |k_j| plus
        the n-term sum's (n + 8) u scale sum_j |dS_ij k_j| (n = Lk); dK_j
        the same over i with q (n = rep Lq, the group's query heads
        summed); dV_j by sum_i P_ij rho_ij |dO_i| + (n + 8) u sum_i P_ij |dO_i|.

    Each evaluation is within that of the exact values; the bound is 4x it
    (2 for the two evaluations, 2 to spare). Inputs as
    :func:`flash_attention_bwd`'s; CUDA or CPU tensors."""
    lq, lk, dh = q.shape[2], k.shape[2], q.shape[3]
    hkv, rep = k.shape[1], q.shape[1] // k.shape[1]
    scale = scale if scale is not None else 1.0 / math.sqrt(dh)
    qf, kf, vf = _gqa(q, k, v)
    do, of = dout.float(), out.float()
    valid = _valid(lq, lk, causal, q.device)
    s = torch.einsum("bhqd,bhkd->bhqk", qf, kf) * scale
    sabs = torch.einsum("bhqd,bhkd->bhqk", qf.abs(), kf.abs()) * scale
    lse_f = torch.where(torch.isfinite(lse), lse, 0.0)[..., None]
    p = torch.where(valid, torch.exp(s - lse_f), 0.0)
    gdh = (dh + 2) * _U32
    rho = gdh * sabs + (s.abs() + lse_f.abs() + 4.0) * _U32
    d = (do * of).sum(dim=-1)[..., None]
    dabs = (do * of).abs().sum(dim=-1)[..., None]
    dp = torch.einsum("bhqd,bhkd->bhqk", do, vf)
    dpabs = torch.einsum("bhqd,bhkd->bhqk", do.abs(), vf.abs())
    ds_abs = (p * (dp - d)).abs()
    e = p * ((rho + 2 * _U32) * (dp - d).abs() + gdh * (dpabs + dabs))
    del s, sabs, dp, dpabs
    kabs, qabs, doabs = kf.abs(), qf.abs(), do.abs()
    dq_b = scale * (torch.einsum("bhqk,bhkd->bhqd", e, kabs)
                    + (lk + 8) * _U32 * torch.einsum("bhqk,bhkd->bhqd", ds_abs, kabs))
    nq = rep * lq + 8
    dk_b = scale * _group_sum(torch.einsum("bhqk,bhqd->bhkd", e, qabs)
                              + nq * _U32 * torch.einsum("bhqk,bhqd->bhkd", ds_abs, qabs), hkv)
    dv_b = _group_sum(torch.einsum("bhqk,bhqd->bhkd", p * rho, doabs)
                      + nq * _U32 * torch.einsum("bhqk,bhqd->bhkd", p, doabs), hkv)
    return 4.0 * dq_b, 4.0 * dk_b, 4.0 * dv_b


#: Limit on ‖kernel − plain‖₂ / ‖plain‖₂ of each of K7b's outputs, beside
#: the elementwise bound (readings in PERF.md).
BWD_NORMWISE_LIMIT = 1e-4


def check_bwd_against_plain(args: tuple, kw: dict, grads_k: tuple | None = None) -> dict:
    """Launch K7b (or take its outputs ``grads_k``) and its plain version
    on the same inputs ``args`` = (q, k, v, out, lse, dout) and hold each
    of dq, dk, dv within :func:`rounding_bound_bwd` elementwise and
    :data:`BWD_NORMWISE_LIMIT` normwise; raises AssertionError. Returns
    the worst ``max_abs_err``, ``max_ratio`` and ``normwise`` of the three
    and each one's under its name."""
    if grads_k is None:
        grads_k = flash_attention_bwd(*args, **kw)
    grads_r = flash_attention_bwd_ref(*args, **kw)
    bounds = rounding_bound_bwd(*args, **kw)
    res = {"max_abs_err": 0.0, "max_ratio": 0.0, "normwise": 0.0}
    for name, gk, gr, bnd in zip(("dq", "dk", "dv"), grads_k, grads_r, bounds):
        if not bool(torch.isfinite(gk).all()):
            raise AssertionError(f"K7b {name}: non-finite values")
        err = (gk - gr).abs()
        ratio = float((err / bnd.clamp_min(1e-30)).max())
        normwise = float(torch.linalg.vector_norm(err)
                         / torch.linalg.vector_norm(gr).clamp_min(1e-30))
        if ratio > 1.0 or normwise > BWD_NORMWISE_LIMIT:
            raise AssertionError(
                f"K7b {name} disagrees with its plain version: max err/bound {ratio:.3g}, "
                f"normwise {normwise:.3g} (limit {BWD_NORMWISE_LIMIT:g})")
        res[name] = {"max_abs_err": float(err.max()), "max_ratio": ratio, "normwise": normwise}
        res["max_abs_err"] = max(res["max_abs_err"], float(err.max()))
        res["max_ratio"] = max(res["max_ratio"], ratio)
        res["normwise"] = max(res["normwise"], normwise)
    return res


def random_bwd_inputs(seed: int, b: int, h: int, hkv: int, lq: int, lk: int, dh: int,
                      dtype: torch.dtype, *, causal: bool = True, heads_last: bool = False,
                      device="cpu") -> tuple:
    """The inputs of one K7b call, for the checks and tests: q, k, v as
    :func:`random_inputs`, K7's output and logsumexp from the plain
    versions, and a normal dO (B, H, Lq, Dh) f32."""
    q, k, v = random_inputs(seed, b, h, hkv, lq, lk, dh, dtype, heads_last=heads_last,
                            device=device)
    out = flash_attention_ref(q, k, v, causal=causal)
    lse = lse_ref(q, k, causal=causal)
    rng = np.random.default_rng(seed + 1)
    dout = torch.as_tensor(rng.normal(size=(b, h, lq, dh)).astype(np.float32), device=device)
    return q, k, v, out, lse, dout
