"""The dense decoder stack: pre-norm blocks of attention and a SwiGLU MLP.

Params are stacked with a leading layer dim, as the JAX package's
`stack_init` builds them, and `stack_apply` loops over that dim in
Python where the reference scans. Caches keep their (L, B, T, Hkv, D)
layout (page pools their (L, P, page_size, Hkv, D) one); layer i works on
views of row i, updated in place.
"""

from __future__ import annotations

import torch

from repro_torch.models import attention as A
from repro_torch.models import ffn as F
from repro_torch.models import layers as L


def _norm_init(cfg, device):
    return L.rmsnorm_init(cfg.d_model, dtype=getattr(torch, cfg.param_dtype),
                          device=device)


def block_init(generator, cfg, *, device):
    return {
        "attn_norm": _norm_init(cfg, device),
        "attn": A.attn_init(generator, cfg, device=device),
        "mlp_norm": _norm_init(cfg, device),
        "mlp": F.mlp_init(generator, cfg, device=device),
    }


def block_apply(p, x, cfg, *, cache=None, cache_pos=None, kv_table=None):
    """Returns (x, cache)."""
    h, cache = A.attn_apply(p["attn"], L.rmsnorm_apply(p["attn_norm"], x),
                            cfg, cache=cache, cache_pos=cache_pos,
                            kv_table=kv_table)
    x = x + h
    # the skip connection rides the down-projection's flush (residual)
    out = F.mlp_apply(p["mlp"], L.rmsnorm_apply(p["mlp_norm"], x), cfg,
                      residual=x)
    return out, cache


def stack_init(generator, cfg, *, device):
    layers = [block_init(generator, cfg, device=device)
              for _ in range(cfg.n_layers)]
    return _stack(layers)


def _stack(trees):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def _index(tree, i):
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]


def stack_apply(params, x, cfg, *, caches=None, cache_pos=None,
                kv_table=None):
    """Returns (x, caches). kv_table (paged decode) has no layer dim: a
    logical page is the same physical page in every layer's pool, so
    every layer gets the same table."""
    n = params["attn_norm"]["scale"].shape[0]
    for i in range(n):
        cache = None if caches is None else _index(caches, i)
        x, _ = block_apply(_index(params, i), x, cfg, cache=cache,
                           cache_pos=cache_pos, kv_table=kv_table)
    return x, caches
