"""Mamba2 / SSD (state-space duality, arXiv:2405.21060).

Port of ``repro.models.mamba2``: the chunked SSD for prefill (quadratic
within a chunk, linear across chunks; the inter-chunk recurrence is a
Python loop over the chunks where JAX scans) and the O(1)-per-token
recurrent form for decode. The state is fp32. ``mamba2_decode`` writes
the new state and conv history into the cache's storage, like the port's
other caches, and returns the cache.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.models import layers
from repro_torch.models import partitioning as pt


class SSMDims(NamedTuple):
    d_model: int
    d_inner: int  # expand * d_model
    n_heads: int  # d_inner / head_dim
    head_dim: int
    d_state: int
    n_groups: int
    d_conv: int


def make_dims(d_model, d_state, *, expand=2, head_dim=64, n_groups=1, d_conv=4) -> SSMDims:
    d_inner = expand * d_model
    return SSMDims(d_model, d_inner, d_inner // head_dim, head_dim, d_state, n_groups, d_conv)


def conv_dim(dims: SSMDims) -> int:
    return dims.d_inner + 2 * dims.n_groups * dims.d_state


def init_mamba2(gen: torch.Generator, dims: SSMDims) -> dict:
    dev = gen.device
    d_in_proj = 2 * dims.d_inner + 2 * dims.n_groups * dims.d_state + dims.n_heads
    f32 = dict(dtype=torch.float32, device=dev)
    return {
        "in_proj": layers.dense_init(gen, dims.d_model, d_in_proj),
        "conv_w": layers.truncated_normal(gen, (dims.d_conv, conv_dim(dims)),
                                          1.0 / math.sqrt(dims.d_conv)),
        "conv_bias": torch.zeros((conv_dim(dims),), **f32),
        "a_log": torch.log(torch.linspace(1.0, 16.0, dims.n_heads, **f32)),
        "dt_bias": torch.zeros((dims.n_heads,), **f32),
        "d_skip": torch.ones((dims.n_heads,), **f32),
        "out_norm": layers.init_rmsnorm(dims.d_inner, dev),
        "out_proj": layers.dense_init(gen, dims.d_inner, dims.d_model),
    }


def _split_proj(z_xbc_dt, dims: SSMDims):
    di, g, n = dims.d_inner, dims.n_groups, dims.d_state
    return (z_xbc_dt[..., :di], z_xbc_dt[..., di:2 * di + 2 * g * n],
            z_xbc_dt[..., 2 * di + 2 * g * n:])


def _split_xbc(xbc, dims: SSMDims):
    gn = dims.n_groups * dims.d_state
    return (xbc[..., :dims.d_inner], xbc[..., dims.d_inner:dims.d_inner + gn],
            xbc[..., dims.d_inner + gn:])


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """Stable segment-sum: out[..., i, j] = sum_{j < s <= i} a[..., s],
    -inf above the diagonal (so exp gives the causal decay matrix)."""
    n = a.shape[-1]
    cum = torch.cumsum(a, dim=-1)
    diff = cum[..., :, None] - cum[..., None, :]
    mask = torch.ones((n, n), dtype=torch.bool, device=a.device).tril()
    return torch.where(mask, diff, -math.inf)


def ssd_chunked(x, dt, a, B, C, dims: SSMDims, chunk: int, init_state=None, einsum_dtype=None):
    """Chunked SSD scan.

    x:  (b, L, h, p) head inputs
    dt: (b, L, h) softplus'd timesteps
    a:  (h,) negative decay rates (-exp(a_log))
    B, C: (b, L, g, n)
    Returns (y (b, L, h, p), final_state (b, h, p, n)).
    """
    b, length, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    chunk = min(chunk, length)
    pad = (-length) % chunk
    if pad:
        # dt=0 padding is exact: decay exp(0)=1, contribution dt*x*B=0,
        # so the final state is untouched and padded outputs are sliced.
        def zpad(t):
            return F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))

        x, dt, B, C = zpad(x), zpad(dt), zpad(B), zpad(C)
        length += pad
    nc = length // chunk
    rep = h // g
    ed = einsum_dtype or torch.float32

    xb = x.reshape(b, nc, chunk, h, p)
    dtb = dt.reshape(b, nc, chunk, h)
    Bh = B.reshape(b, nc, chunk, g, n).repeat_interleave(rep, dim=3)  # (b,nc,l,h,n)
    Ch = C.reshape(b, nc, chunk, g, n).repeat_interleave(rep, dim=3)

    da_t = (dtb * a[None, None, None, :]).transpose(2, 3)  # (b,nc,h,l)
    lmat = torch.exp(_segsum(da_t))  # (b,nc,h,l,l)

    # intra-chunk (quadratic within the chunk); with einsum_dtype bf16 the
    # big products run in bf16, the decay and cumsum math stays fp32
    s = torch.einsum("bclhn,bcmhn->bchlm", Ch.to(ed), Bh.to(ed))
    xdt = dtb.to(ed)[..., None] * xb.to(ed)  # (b,nc,m,h,p)
    y_diag = torch.einsum("bchlm,bcmhp->bclhp", s * lmat.to(ed), xdt).float()

    # chunk-final states
    cums = torch.cumsum(da_t, dim=-1)
    decay_to_end = torch.exp(cums[..., -1:] - cums)  # (b,nc,h,l)
    bw = Bh.to(ed) * (decay_to_end.transpose(2, 3).to(ed) * dtb.to(ed))[..., None]
    states = torch.einsum("bclhn,bclhp->bchpn", bw, xb.to(ed)).float()

    # inter-chunk recurrence, chunk by chunk
    chunk_decay = torch.exp(cums[..., -1])  # (b,nc,h) total decay per chunk
    carry = (init_state if init_state is not None
             else torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device))
    entering = []
    for c in range(nc):
        entering.append(carry)  # the state entering chunk c
        carry = carry * chunk_decay[:, c, :, None, None] + states[:, c]
    entering = torch.stack(entering, dim=1)  # (b,nc,h,p,n)

    # contribution of the entering state to each position
    decay_from_start = torch.exp(cums)  # (b,nc,h,l)
    cw = Ch.to(ed) * decay_from_start.transpose(2, 3).to(ed)[..., None]
    y_off = torch.einsum("bclhn,bchpn->bclhp", cw, entering.to(ed)).float()
    y = (y_diag + y_off).reshape(b, length, h, p)
    if pad:
        y = y[:, :length - pad]
    return y, carry


class Mamba2Cache(NamedTuple):
    state: torch.Tensor  # (B, h, p, n) fp32 SSM state
    conv_buf: torch.Tensor  # (B, d_conv-1, conv_dim) fp32 conv history

    @classmethod
    def init(cls, batch, dims: SSMDims, device=None):
        return cls(
            state=torch.zeros((batch, dims.n_heads, dims.head_dim, dims.d_state),
                              dtype=torch.float32, device=device),
            conv_buf=torch.zeros((batch, dims.d_conv - 1, conv_dim(dims)),
                                 dtype=torch.float32, device=device))


def _mixer(proj, conv_w, conv_bias, dt_bias, a_log, d_skip, dims: SSMDims, chunk: int,
           ssd_compute: str):
    """The causal depthwise conv, the chunked SSD and the gate on the input
    projection ``proj`` (B, L, ...). Returns (y (B, L, d_inner) f32, the
    final state, the conv tail)."""
    bsz, length, _ = proj.shape
    z, xbc, dt = _split_proj(proj, dims)
    # causal depthwise conv over xbc
    w = conv_w.float()  # (d_conv, conv_dim)
    xbc_f = xbc.float()
    conv_tail = xbc_f[:, length - (dims.d_conv - 1):, :]  # decode conv history
    padded = F.pad(xbc_f, (0, 0, dims.d_conv - 1, 0))
    conv = padded[:, 0:length] * w[0][None, None, :]
    for i in range(1, dims.d_conv):
        conv = conv + padded[:, i:i + length] * w[i][None, None, :]
    xs, Bc, Cc = _split_xbc(F.silu(conv + conv_bias), dims)
    xh = xs.reshape(bsz, length, dims.n_heads, dims.head_dim)
    Bm = Bc.reshape(bsz, length, dims.n_groups, dims.d_state)
    Cm = Cc.reshape(bsz, length, dims.n_groups, dims.d_state)
    dt_ = F.softplus(dt.float() + dt_bias)
    a = -torch.exp(a_log.float())
    y, state = ssd_chunked(xh.float(), dt_, a, Bm, Cm, dims, chunk,
                           einsum_dtype=torch.bfloat16 if ssd_compute == "bf16" else torch.float32)
    y = y + xh.float() * d_skip[None, None, :, None]
    y = y.reshape(bsz, length, dims.d_inner) * F.silu(z.float())  # gated
    return y, state, conv_tail


def mamba2_forward(p, x, dims: SSMDims, *, chunk=128, compute_dtype=layers.DEFAULT_COMPUTE,
                   ssd_compute: str = "fp32"):
    """Full-sequence Mamba2 block. x: (B, L, d_model).

    Returns (out, Mamba2Cache): the cache is decode-ready (the final SSM
    state and the last d_conv - 1 raw conv inputs). Under a mesh the
    projection is split over "model" as JAX's hint lays it out (its last
    axis there), then gathered: each rank runs the conv and the SSD on its
    own rows, whole (``partitioning.on_local``; their weights' gradients
    sum over DP), so every model rank repeats them."""
    bsz, length, _ = x.shape
    proj = pt.act(pt.column_parallel(x.to(compute_dtype), p["in_proj"].to(compute_dtype)),
                  "batch", None, "model")
    rows = ("batch", None, None)
    y, state, conv_tail = pt.on_local(
        lambda *a: _mixer(*a, dims=dims, chunk=chunk, ssd_compute=ssd_compute),
        (proj, p["conv_w"], p["conv_bias"], p["dt_bias"], p["a_log"], p["d_skip"]),
        (rows, (), (), (), (), ()), (rows, ("batch", None, None, None), rows),
        ((bsz, length, dims.d_inner), (bsz, dims.n_heads, dims.head_dim, dims.d_state),
         (bsz, dims.d_conv - 1, conv_dim(dims))),
        partial={i: ("batch",) for i in range(1, 6)})
    y = layers.rms_norm(p["out_norm"], y.to(compute_dtype))
    out = pt.row_parallel(y, p["out_proj"].to(compute_dtype))
    return out, Mamba2Cache(state=state, conv_buf=conv_tail)


def _recurrent_step(proj, conv_buf, state, conv_w, conv_bias, dt_bias, a_log, d_skip, *,
                    dims: SSMDims):
    """One token's conv and SSM recurrence on whole rows: proj (B, d_in_proj)
    -> (y (B, d_inner) f32, before the gate's norm, the new state, the new
    conv history)."""
    bsz = proj.shape[0]
    z, xbc, dt = _split_proj(proj, dims)  # (B, *)
    hist = torch.cat([conv_buf, xbc.float()[:, None]], dim=1)
    conv = torch.einsum("btc,tc->bc", hist, conv_w.float()) + conv_bias
    xs, Bc, Cc = _split_xbc(F.silu(conv), dims)
    xh = xs.reshape(bsz, dims.n_heads, dims.head_dim)
    rep = dims.n_heads // dims.n_groups
    Bm = Bc.reshape(bsz, dims.n_groups, dims.d_state).repeat_interleave(rep, dim=1)
    Cm = Cc.reshape(bsz, dims.n_groups, dims.d_state).repeat_interleave(rep, dim=1)
    dt_ = F.softplus(dt.float() + dt_bias)  # (B, h)
    a = -torch.exp(a_log.float())
    decay = torch.exp(dt_ * a[None, :])
    state = (state * decay[..., None, None]
             + torch.einsum("bh,bhp,bhn->bhpn", dt_, xh, Bm))
    y = torch.einsum("bhpn,bhn->bhp", state, Cm)
    y = y + xh * d_skip[None, :, None]
    return y.reshape(bsz, dims.d_inner) * F.silu(z.float()), state, hist[:, 1:]


def mamba2_decode(p, x, cache: Mamba2Cache, dims: SSMDims,
                  compute_dtype=layers.DEFAULT_COMPUTE):
    """Single-token recurrent step. x: (B, 1, d_model). Writes the new
    state and conv history into ``cache``'s storage and returns it. Under
    a mesh, as the forward: the projection split over "model", then each
    rank's rows run the conv and the recurrence whole
    (``partitioning.on_local``: the state and conv history are gathered
    over the axes JAX's cache layout splits them on, and each rank writes
    its shard back)."""
    bsz = x.shape[0]
    proj = pt.column_parallel(x.to(compute_dtype), p["in_proj"].to(compute_dtype))[:, 0]
    weights = (p["conv_w"], p["conv_bias"], p["dt_bias"], p["a_log"], p["d_skip"])
    if pt.is_dtensor(proj):
        rows = ("batch", None)
        y, state, conv_buf = pt.on_local(
            lambda *a: _recurrent_step(*a, dims=dims),
            (pt.act(proj, "batch", "model"), cache.conv_buf, cache.state, *weights),
            (rows, ("batch", None, None), ("batch", None, None, None)) + ((),) * 5,
            (rows, ("batch", None, None, None), ("batch", None, None)),
            ((bsz, dims.d_inner), tuple(cache.state.shape), tuple(cache.conv_buf.shape)))
    else:
        y, state, conv_buf = _recurrent_step(proj, cache.conv_buf, cache.state, *weights,
                                             dims=dims)
    y = layers.rms_norm(p["out_norm"], y.to(compute_dtype))
    cache.state.copy_(state)
    cache.conv_buf.copy_(conv_buf)
    return pt.row_parallel(y, p["out_proj"].to(compute_dtype))[:, None], cache
