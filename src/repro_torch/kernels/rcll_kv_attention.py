"""K6: one-token GQA decode attention over the RCLL-KV cache.

Replaces the Pallas kernel ``repro/kernels/rcll_kv_attention.py::
rcll_kv_decode`` with the hand-written CUDA kernel
``csrc/rcll_kv_attention.cu``. RCLL-KV stores each cache block of K and
V as ``anchor (fp32) + scale (fp32) * residual`` with an int8 (levels
times 1/127), fp16 or bf16 residual (``core.anchored``). The kernel
splits the keys below each row's length over CTAs, one per cache block,
each of which copies its residual tiles into shared memory
asynchronously, dequantizes them on chip and runs the ``rep`` query heads
of its kv head against them; a second kernel of the same call merges the
blocks' softmax partials in a fixed order. Decode attention streams the
cache, so its bound on the H100 is bytes (see the source's note and
PERF.md).

Layouts are JAX's: q (B, H, Dh) f32; residuals (B, Hkv, nblk, blk, Dh);
anchors and scales (B, Hkv, nblk, 1, Dh) f32; length (B,) int32. The
kernel takes element strides, so permuted views of the model's cache
need no copy.

:func:`rcll_kv_decode` launches the kernel for CUDA tensors and takes the
plain version :func:`rcll_kv_decode_ref` only for CPU tensors. With
``return_stats`` it also returns each row's softmax max ``m`` and
denominator ``l`` (B, H), which ``models.attention`` uses to merge the
open tail block. The two agree within ``flash_attention.rounding_bound``;
the dequantized keys and values are equal bit for bit.
``rcll_kv_decode.launches`` counts launches.
"""
from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from repro_torch.core import anchored
from repro_torch.kernels import _build, cost
from repro_torch.kernels.flash_attention import NEG_INF, compare, rounding_bound

_RESID_KIND = {torch.int8: 0, torch.float16: 1, torch.bfloat16: 2}
MAX_REP = 8
MAX_HEAD_DIM = 128


def dequant(resid: torch.Tensor, anchor: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """anchor + scale * residual, the product and the sum rounded apart."""
    return anchor + scale * anchored.dequantize_residual(resid)


def _flat_kv(resid, anchor, scale, rep):
    """Dequantized (B, H, nblk * blk, Dh) keys or values, repeated to q's heads."""
    b, hkv, nblk, blk, dh = resid.shape
    return dequant(resid, anchor, scale).reshape(b, hkv, nblk * blk, dh).repeat_interleave(
        rep, dim=1)


def rcll_kv_decode_ref(q, k_resid, k_anchor, k_scale, v_resid, v_anchor, v_scale, length, *,
                       scale: float | None = None, return_stats: bool = False):
    """Plain PyTorch version of :func:`rcll_kv_decode` (``ref_rcll_kv_decode``'s
    math in one softmax; a row with length 0 gives 0, m = -1e30, l = 0)."""
    b, h, dh = q.shape
    rep = h // k_resid.shape[1]
    kk = _flat_kv(k_resid, k_anchor, k_scale, rep)
    vv = _flat_kv(v_resid, v_anchor, v_scale, rep)
    sc = scale if scale is not None else 1.0 / math.sqrt(dh)
    s = torch.einsum("bhd,bhkd->bhk", q.float(), kk) * sc
    pos = torch.arange(kk.shape[2], device=q.device)
    s = torch.where(pos[None, None, :] < length[:, None, None], s, NEG_INF)
    m = s.amax(dim=-1)
    p = torch.where(s > NEG_INF / 2, torch.exp(s - m[..., None]), 0.0)
    den = p.sum(dim=-1)
    out = torch.einsum("bhk,bhkd->bhd", p, vv) / torch.where(den > 0, den, 1.0)[..., None]
    return (out, m, den) if return_stats else out


def check_against_plain(args: tuple, kw: dict, stats: tuple | None = None) -> dict:
    """Launch K6 (or take its ``(out, m, l)`` as ``stats``) and its plain
    version on the same inputs (CUDA tensors): ``out`` under
    ``flash_attention.rounding_bound`` on the dequantized keys and values
    and its normwise limit, and ``m`` and ``l`` within the same relative
    bound. Raises AssertionError."""
    q, kr, ka, ks, vr, va, vs, length = args
    scale = kw.get("scale") or 1.0 / math.sqrt(q.shape[-1])
    out_k, m_k, l_k = stats or rcll_kv_decode(*args, scale=scale, return_stats=True)
    out_r, m_r, l_r = rcll_kv_decode_ref(*args, scale=scale, return_stats=True)
    rep = q.shape[1] // kr.shape[1]
    kk, vv = _flat_kv(kr, ka, ks, rep), _flat_kv(vr, va, vs, rep)
    pos = torch.arange(kk.shape[2], device=q.device)
    valid = (pos[None, :] < length[:, None])[:, None, None, :]
    qf = q.float()[:, :, None]
    res = compare("K6", out_k, out_r, rounding_bound(qf, kk, vv, valid, scale)[:, :, 0])
    # m is one score (off by E); l a sum of n weights, each off by 2E + ulps
    rel = rounding_bound(qf, kk, vv, valid, scale, relative=True)[:, :, 0, 0]
    if not (bool(torch.equal(m_k <= NEG_INF / 2, m_r <= NEG_INF / 2))
            and bool(((m_k - m_r).abs() <= rel * m_r.abs().clamp_min(1.0)).all())
            and bool(((l_k - l_r).abs() <= rel * l_r).all())):
        raise AssertionError("K6's softmax statistics (m, l) disagree with its plain version")
    return res


class KvParams(ctypes.Structure):
    _fields_ = [("scale", ctypes.c_float), ("inv_levels", ctypes.c_float),
                ("len_shift_blocks", ctypes.c_int), ("drop_last_split", ctypes.c_int)]


def kernel_params(*, scale: float) -> KvParams:
    """The kernel's run-time parameters: the score scale, the int8 level
    step 1/127 (rounded to fp32, as the plain version's), a length shift
    of 0 blocks and no split dropped from the merge
    (:func:`planted_params` plants faults through them without touching
    the source)."""
    return KvParams(scale, 1.0 / 127.0, 0, 0)


#: The faults :func:`planted_params` plants.
FAULTS = ("len_one_block_short", "divisor_128", "drop_last_split")


def planted_params(fault: str):
    """A stand-in for :func:`kernel_params` with ``fault`` planted: the
    length mask one block short, the int8 level step 1/128 for 1/127, or
    the merge skipping each row's last split. A check rebinds
    ``kernel_params`` to it, and must then fail."""
    if fault not in FAULTS:
        raise ValueError(f"unknown fault {fault!r}, not in {FAULTS}")
    clean = kernel_params

    def faulty(**kw) -> KvParams:
        p = clean(**kw)
        if fault == "len_one_block_short":
            p.len_shift_blocks = -1
        elif fault == "divisor_128":
            p.inv_levels = 1.0 / 128.0
        else:
            p.drop_last_split = 1
        return p

    return faulty


def grid(k_resid: torch.Tensor) -> tuple[int, int]:
    """(CTAs, splits per (b, kv head)) of one launch's split kernel on
    these residuals: one CTA per (cache block, b, kv head)."""
    b, hkv, nblk, _, _ = k_resid.shape
    return nblk * b * hkv, nblk


def random_inputs(seed: int, b: int, h: int, hkv: int, dh: int, nblk: int, blk: int,
                  resid: torch.dtype, lengths, *, heads_last: bool = False,
                  device="cpu") -> tuple:
    """The inputs of one K6 call, for the checks and tests: q (B, H, Dh)
    and K/V of (B, Hkv, nblk * blk, Dh), normal with a per-block offset
    (so the anchors matter), encoded by ``core.anchored`` into residuals,
    anchors and scales, and ``lengths`` (B,) int32. ``heads_last`` gives
    permuted views of a (B, nblk, blk, Hkv, Dh) cache, as the model passes."""
    rng = np.random.default_rng(seed)
    n = nblk * blk
    parts = [torch.as_tensor(rng.normal(size=(b, h, dh)).astype(np.float32), device=device)]
    for _ in range(2):
        x = rng.normal(size=(b, hkv, n, dh)) + np.repeat(rng.normal(size=(b, hkv, nblk, 1, dh)),
                                                         blk, axis=3).reshape(b, hkv, n, dh)
        e = anchored.encode(torch.as_tensor(x.astype(np.float32), device=device), block=blk,
                            axis=2, dtype=resid)
        for t in (e.residual, e.anchor, e.scale):
            parts.append(t.permute(0, 2, 3, 1, 4).contiguous().permute(0, 3, 1, 2, 4)
                         if heads_last else t)
    parts.append(torch.as_tensor(np.asarray(lengths, np.int32), device=device))
    return tuple(parts)


@functools.cache
def _entry():
    fn = _build.library().lib.repro_rcll_kv_decode
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 12 + [ctypes.c_int] * 6
                   + [ctypes.c_void_p] * 3)
    fn.restype = ctypes.c_int
    return fn


def _check_inputs(q, k_resid, k_anchor, k_scale, v_resid, v_anchor, v_scale, length):
    if q.dim() != 3 or q.dtype != torch.float32:
        raise ValueError(f"q must be (B, H, Dh) float32, got {tuple(q.shape)} {q.dtype}")
    b, h, dh = q.shape
    if k_resid.dim() != 5 or v_resid.shape != k_resid.shape:
        raise ValueError("residuals must be (B, Hkv, nblk, blk, Dh) and alike")
    _, hkv, nblk, blk, _ = k_resid.shape
    if k_resid.shape[0] != b or k_resid.shape[4] != dh or h % hkv:
        raise ValueError(f"q {tuple(q.shape)} and residuals {tuple(k_resid.shape)} do not match")
    if k_resid.dtype not in _RESID_KIND or v_resid.dtype != k_resid.dtype:
        raise ValueError(f"residuals must share int8, fp16 or bf16, got {k_resid.dtype}")
    for name, t in (("k_anchor", k_anchor), ("k_scale", k_scale), ("v_anchor", v_anchor),
                    ("v_scale", v_scale)):
        if tuple(t.shape) != (b, hkv, nblk, 1, dh) or t.dtype != torch.float32:
            raise ValueError(f"{name} must be ({b}, {hkv}, {nblk}, 1, {dh}) float32")
    if tuple(length.shape) != (b,) or length.dtype != torch.int32:
        raise ValueError("length must be (B,) int32")
    if h // hkv > MAX_REP or dh > MAX_HEAD_DIM:
        raise ValueError(f"the kernel takes at most {MAX_REP} query heads per kv head "
                         f"and head dim {MAX_HEAD_DIM}")
    if b * hkv > 65535:
        raise ValueError(f"the kernel takes at most 65535 (b, kv head) pairs, got {b * hkv}")
    tensors = (q, k_resid, k_anchor, k_scale, v_resid, v_anchor, v_scale, length)
    if any(t.device != q.device for t in tensors):
        raise ValueError("all inputs must be on one device")


def rcll_kv_decode(q, k_resid, k_anchor, k_scale, v_resid, v_anchor, v_scale, length, *,
                   scale: float | None = None, return_stats: bool = False):
    """Decode attention of q (B, H, Dh) over the anchored blocks below
    ``length`` -> out (B, H, Dh) f32, and with ``return_stats`` also the
    rows' softmax max and denominator (B, H) f32.

    CPU tensors take :func:`rcll_kv_decode_ref`; CUDA tensors launch the
    kernel or raise (also when a cache block's K and V tiles do not fit
    in the card's shared memory); meta tensors (the dry run) give empty
    outputs of the right shapes. A call keeps no state between
    launches, so it can be captured in a CUDA graph and replayed. Under
    the dry run's counter a call counts :func:`k6_cost`.
    """
    args = (q, k_resid, k_anchor, k_scale, v_resid, v_anchor, v_scale, length)

    def run(*args):
        q = args[0]
        if q.device.type == "cpu":
            return rcll_kv_decode_ref(*args, scale=scale, return_stats=return_stats)
        if q.device.type == "meta":
            _check_inputs(*args)
            b, h, dh = q.shape
            out = q.new_empty((b, h, dh))
            return (out, q.new_empty((b, h)), q.new_empty((b, h))) if return_stats else out
        return _launch(args, scale, return_stats)

    return cost.kernel("rcll_kv_decode", lambda q, k_resid, *_: k6_cost(q, k_resid), run, args)


def k6_cost(q, k_resid) -> tuple:
    """(FLOPs, bytes, on the tensor cores: no) of one K6 call, for the dry
    run's counter. Every key of the cache's capacity is counted, whatever
    the lengths (a count from shapes alone, the same on meta and on the
    card): per key and kv head, 4 Dh to dequantize k and v and 4 Dh for
    each of its query heads (q.k and p.v); the residuals, anchors and
    scales of every block read once, q read and out, m, l written in fp32."""
    b, h, dh = q.shape
    _, hkv, nblk, blk, _ = k_resid.shape
    keys = b * hkv * nblk * blk
    nbytes = (b * hkv * nblk * (2 * blk * dh * k_resid.element_size() + 4 * dh * 4)
              + q.numel() * 4 + b * h * (dh + 2) * 4 + b * 4)
    return keys * dh * (4 + 4 * (h // hkv)), nbytes, False


def _launch(args, scale, return_stats: bool):
    """Launch K6 on CUDA tensors."""
    q, k_resid = args[0], args[1]
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"rcll_kv_decode runs on cuda, cpu or meta tensors, got {dev}")
    _check_inputs(*args)
    q, length = args[0].contiguous(), args[7].contiguous()
    args = (q, *args[1:7], length)
    b, h, dh = q.shape
    _, hkv, nblk, blk, _ = k_resid.shape
    scale = float(scale if scale is not None else 1.0 / math.sqrt(dh))
    out = torch.empty((b, h, dh), dtype=torch.float32, device=dev)
    m = torch.empty((b, h), dtype=torch.float32, device=dev)
    den = torch.empty((b, h), dtype=torch.float32, device=dev)
    # each cache block's partial (acc, m, l) of each row, merged by the second kernel
    ws = torch.empty((b * h * nblk * (dh + 2),), dtype=torch.float32, device=dev)
    strides = (ctypes.c_longlong * 30)(*(s for t in args[1:7] for s in t.stride()))
    params = kernel_params(scale=scale)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _entry()(_RESID_KIND[k_resid.dtype], *(t.data_ptr() for t in args),
                      out.data_ptr(), m.data_ptr(), den.data_ptr(), ws.data_ptr(), b, hkv,
                      h // hkv, nblk, blk, dh, ctypes.addressof(strides),
                      ctypes.addressof(params), stream)
    _build.check_rc(rc, "rcll_kv_decode")
    _WRAPPER.launches += 1
    return (out, m, den) if return_stats else out


rcll_kv_decode.launches = 0
# The counter lives on this function object even if the module attribute
# is rebound (e.g. by a harness that wraps the wrapper).
_WRAPPER = rcll_kv_decode
