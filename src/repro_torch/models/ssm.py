"""Mamba-2 blocks (SSD, the state-space duality), as the JAX package's
`repro/models/ssm.py` builds them: d_inner = expand * d_model, H heads
of size P = head_dim, G state groups of size N = d_state, a short causal
depthwise conv of width W over the (x, B, C) channels.

The full-sequence pass (`mamba_apply`, prefill) sends its scan to the
SSD chokepoint (`core.ssd`, the intra-chunk CUDA kernel on the card);
the one-token step (`mamba_decode`) is the plain recurrence. Every
projection goes through the GEMM chokepoint. bf16 rounds where the JAX
code rounds: the prefill conv sums its taps one bf16 add at a time, the
decode conv accumulates in f32 and rounds once.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.core import ssd as _core_ssd
from repro_torch.models import layers as L


def _dims(cfg, d_model=None):
    sc = cfg.ssm
    d = d_model or cfg.d_model
    d_inner = sc.expand * d
    h = d_inner // sc.head_dim
    conv_dim = d_inner + 2 * sc.n_groups * sc.d_state
    return d, d_inner, h, conv_dim


def mamba_init(generator, cfg, *, device, d_model=None):
    """The JAX package's params: two input projections (z/x, and B/C/dt),
    the conv weights of each, A_log, D, dt_bias, the gated norm and
    out_proj, at the same shapes, scales and dtypes."""
    sc = cfg.ssm
    d, d_inner, h, _ = _dims(cfg, d_model)
    dtype = getattr(torch, cfg.param_dtype)
    gn2 = 2 * sc.n_groups * sc.d_state
    f32 = torch.float32

    def normal(*shape, scale):
        w = torch.randn(shape, generator=generator, dtype=f32,
                        device=generator.device) * scale
        return w.to(device=device, dtype=dtype)

    u = torch.rand((h,), generator=generator, dtype=f32,
                   device=generator.device).to(device)
    dt = torch.exp(u * (math.log(0.1) - math.log(1e-3)) + math.log(1e-3))
    return {
        "in_proj": L.dense_init(generator, d, 2 * d_inner, dtype=dtype,
                                device=device),
        "in_proj_bc": L.dense_init(generator, d, gn2 + h, dtype=dtype,
                                   device=device),
        "conv_w": normal(sc.conv_width, d_inner, scale=sc.conv_width ** -0.5),
        "conv_b": torch.zeros((d_inner,), dtype=dtype, device=device),
        "conv_bc_w": normal(sc.conv_width, gn2, scale=sc.conv_width ** -0.5),
        "conv_bc_b": torch.zeros((gn2,), dtype=dtype, device=device),
        "A_log": torch.log(torch.linspace(1.0, 16.0, h, dtype=f32,
                                          device=device)),
        "D": torch.ones((h,), dtype=f32, device=device),
        "dt_bias": dt + torch.log(-torch.expm1(-dt)),
        "norm": L.rmsnorm_init(d_inner, dtype=dtype, device=device),
        "out_proj": L.dense_init(generator, d_inner, d, dtype=dtype,
                                 device=device,
                                 scale=d_inner ** -0.5
                                 / (2 * cfg.n_layers) ** 0.5),
    }


def _project(p, x, cfg, d_model=None):
    """-> (z, x_pre_conv, bc_pre_conv, dt_raw)."""
    _, d_inner, h, _ = _dims(cfg, d_model)
    zx = L.dense_apply(p["in_proj"], x)
    bcdt = L.dense_apply(p["in_proj_bc"], x)
    return zx[..., :d_inner], zx[..., d_inner:], bcdt[..., :-h], bcdt[..., -h:]


def _causal_conv(xbc, w, b):
    """Depthwise causal conv over (B, L, C) with weight (W, C): each tap's
    product, then the taps summed one add at a time, in xbc's dtype."""
    width = w.shape[0]
    pad = F.pad(xbc, (0, 0, width - 1, 0))
    out = pad[:, 0:xbc.shape[1]] * w[0]
    for i in range(1, width):
        out = out + pad[:, i:i + xbc.shape[1]] * w[i]
    return out + b


def mamba_apply(p, x, cfg, *, d_model=None, return_state: bool = False):
    """Full-sequence (prefill) pass over x (B, L, D). With return_state,
    also the state a decode continues from: the final SSD state and the
    conv caches, the last W - 1 *pre-conv* channel values."""
    sc = cfg.ssm
    _, d_inner, h, _ = _dims(cfg, d_model)
    bsz, l, _ = x.shape
    gn = sc.n_groups * sc.d_state

    z, xs_pre, bc_pre, dt_raw = _project(p, x, cfg, d_model)
    xsc = F.silu(_causal_conv(xs_pre, p["conv_w"].to(x.dtype),
                              p["conv_b"].to(x.dtype)))
    bcc = F.silu(_causal_conv(bc_pre, p["conv_bc_w"].to(x.dtype),
                              p["conv_bc_b"].to(x.dtype)))
    xs = xsc.reshape(bsz, l, h, sc.head_dim)
    b_ = bcc[..., :gn].reshape(bsz, l, sc.n_groups, sc.d_state)
    c_ = bcc[..., gn:].reshape(bsz, l, sc.n_groups, sc.d_state)

    dt = F.softplus(dt_raw.float() + p["dt_bias"])            # (B,L,H)
    a_neg = -torch.exp(p["A_log"]) * dt                       # (B,L,H)

    # pad L to a chunk multiple; dt = 0 makes the pad steps identities of
    # the recurrence (decay exp(0) = 1, no state contribution)
    chunk = min(sc.chunk, l)
    pad = (-l) % chunk
    xdt = xs.float() * dt[..., None]
    bf, cf = b_.float(), c_.float()
    if pad:
        xdt, bf, cf = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (xdt, bf, cf))
        a_neg = F.pad(a_neg, (0, 0, 0, pad))

    y, s_final = _core_ssd.ssd(xdt, a_neg, bf, cf, chunk)
    y = y[:, :l] + p["D"][:, None] * xs.float()
    y = y.reshape(bsz, l, d_inner).to(x.dtype)
    y = L.rmsnorm_apply(p["norm"], y * F.silu(z))
    out = L.dense_apply(p["out_proj"], y)
    if not return_state:
        return out, None
    # The tail is re-projected, not sliced from the padded conv input: a
    # prompt shorter than W - 1 left-pads the *projected* tail with zeros,
    # as the zero conv buffers of mamba_init_state hold after l tokens (a
    # dense of zero tokens is not zero).
    w1 = sc.conv_width - 1
    _, xs_tail, bc_tail, _ = _project(p, x[:, -w1:], cfg, d_model)
    if xs_tail.shape[1] < w1:
        padn = w1 - xs_tail.shape[1]
        xs_tail = F.pad(xs_tail, (0, 0, padn, 0))
        bc_tail = F.pad(bc_tail, (0, 0, padn, 0))
    return out, {"ssd": s_final, "conv": xs_tail, "conv_bc": bc_tail}


def mamba_init_state(cfg, bsz, *, device, d_model=None, dtype=torch.float32):
    sc = cfg.ssm
    _, d_inner, h, _ = _dims(cfg, d_model)
    gn2 = 2 * sc.n_groups * sc.d_state
    return {
        "ssd": torch.zeros((bsz, h, sc.head_dim, sc.d_state),
                           dtype=torch.float32, device=device),
        "conv": torch.zeros((bsz, sc.conv_width - 1, d_inner), dtype=dtype,
                            device=device),
        "conv_bc": torch.zeros((bsz, sc.conv_width - 1, gn2), dtype=dtype,
                               device=device),
    }


def mamba_decode(p, x_t, cfg, state, *, d_model=None):
    """Single-token step. x_t: (B, 1, D); state keys ssd/conv/conv_bc.
    Returns (out, new_state); `state` is not modified."""
    sc = cfg.ssm
    _, d_inner, h, _ = _dims(cfg, d_model)
    bsz = x_t.shape[0]
    gn = sc.n_groups * sc.d_state

    z, xs_new, bc_new, dt_raw = _project(p, x_t, cfg, d_model)

    def conv_step(buf, new, w, bias):
        # an einsum over the window: f32 products summed, rounded once
        cat = torch.cat([buf, new.to(buf.dtype)], dim=1)       # (B,W,C)
        out = (cat.to(x_t.dtype).float()
               * w.to(x_t.dtype).float()).sum(1).to(x_t.dtype)
        return F.silu(out + bias.to(x_t.dtype)), cat[:, 1:]

    xbc, new_conv = conv_step(state["conv"], xs_new, p["conv_w"], p["conv_b"])
    bcc, new_conv_bc = conv_step(state["conv_bc"], bc_new, p["conv_bc_w"],
                                 p["conv_bc_b"])

    xs = xbc.reshape(bsz, h, sc.head_dim)
    rep = h // sc.n_groups
    b_h = bcc[:, :gn].reshape(bsz, sc.n_groups, sc.d_state) \
        .repeat_interleave(rep, 1).float()                    # (B,H,N)
    c_h = bcc[:, gn:].reshape(bsz, sc.n_groups, sc.d_state) \
        .repeat_interleave(rep, 1).float()

    dt = F.softplus(dt_raw[:, 0].float() + p["dt_bias"])      # (B,H)
    da = torch.exp(-torch.exp(p["A_log"]) * dt)
    xf = xs.float() * dt[..., None]                           # (B,H,P)

    s = state["ssd"] * da[..., None, None] + xf[..., None] * b_h[:, :, None]
    y = (s * c_h[:, :, None]).sum(-1)                         # (B,H,P)
    y = y + p["D"][:, None] * xs.float()
    y = y.reshape(bsz, 1, d_inner).to(x_t.dtype)
    y = L.rmsnorm_apply(p["norm"], y * F.silu(z))
    out = L.dense_apply(p["out_proj"], y)
    return out, {"ssd": s, "conv": new_conv, "conv_bc": new_conv_bc}
