"""SwiGLU feed-forward block. The gate/up GEMMs run as one dual-GEMM
kernel and the block's skip connection rides the down-projection's
flush (`residual=`)."""

from __future__ import annotations

import torch

from repro_torch.models import layers as L


def mlp_init(generator, cfg, *, device):
    d, f = cfg.d_model, cfg.d_ff
    dtype = getattr(torch, cfg.param_dtype)
    down_scale = f ** -0.5 / (2 * cfg.n_layers) ** 0.5
    return {
        "w_gate": L.dense_init(generator, d, f, dtype=dtype, device=device),
        "w_up": L.dense_init(generator, d, f, dtype=dtype, device=device),
        "w_down": L.dense_init(generator, f, d, dtype=dtype, device=device,
                               scale=down_scale),
    }


def mlp_apply(p, x, cfg, *, residual=None):
    h = L.gated_apply(p["w_gate"], p["w_up"], x)
    return L.dense_apply(p["w_down"], h, residual=residual)
