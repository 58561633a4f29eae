"""Feed-forward blocks. SwiGLU (`mlp="swiglu"`): the gate/up GEMMs run
as one dual-GEMM kernel and the block's skip connection rides the
down-projection's flush (`residual=`). GELU (`mlp="gelu"`, Whisper):
w_in's bias and the gelu ride its GEMM's flush (`bias_gelu`); w_out's
bias rides its flush and the skip connection is added after (the
epilogue lattice takes a bias or a residual, not both; `core.gemm`).

Under a "model" group (`distributed.context.model_group`) the SwiGLU
MLP is tensor-parallel: gate and up are column-parallel over this rank's
block of d_ff (the input's cotangent all-reduced backward), down is
row-parallel, and its bias and the skip connection are added once,
after the sum."""

from __future__ import annotations

import torch

from repro_torch.core import distributed as D
from repro_torch.distributed import context as ctx
from repro_torch.models import layers as L


def mlp_init(generator, cfg, *, device):
    d, f = cfg.d_model, cfg.d_ff
    dtype = getattr(torch, cfg.param_dtype)
    down_scale = f ** -0.5 / (2 * cfg.n_layers) ** 0.5
    if cfg.mlp == "gelu":
        return {
            "w_in": L.dense_init(generator, d, f, dtype=dtype, device=device,
                                 bias=True),
            "w_out": L.dense_init(generator, f, d, dtype=dtype,
                                  device=device, bias=True, scale=down_scale),
        }
    return {
        "w_gate": L.dense_init(generator, d, f, dtype=dtype, device=device),
        "w_up": L.dense_init(generator, d, f, dtype=dtype, device=device),
        "w_down": L.dense_init(generator, f, d, dtype=dtype, device=device,
                               scale=down_scale),
    }


def mlp_apply(p, x, cfg, *, residual=None):
    if cfg.mlp == "gelu":
        h = L.dense_apply(p["w_in"], x, activation="gelu")
        return L.dense_apply(p["w_out"], h, residual=residual)
    group = ctx.model_group()
    if group is not None:
        h = L.gated_apply(p["w_gate"], p["w_up"], D.copy_to(x, group))
        return L.row_parallel_apply(p["w_down"], h, group, residual=residual)
    h = L.gated_apply(p["w_gate"], p["w_up"], x)
    return L.dense_apply(p["w_down"], h, residual=residual)
