"""The decoder stacks: pre-norm blocks of attention and a SwiGLU MLP
(family dense), and pre-norm Mamba-2 blocks (family ssm).

Params are stacked with a leading layer dim, as the JAX package's
`stack_init` builds them, and `stack_apply` loops over that dim in
Python where the reference scans. The stacked leaves stay the leaves of
the param tree: layer i works on views of row i, so a gradient comes back
as one tensor per stacked leaf, as the reference's scan gives it. Caches
keep their (L, B, T, Hkv, D) layout (page pools their (L, P, page_size,
Hkv, D) one), updated in place. Rematerialisation (the reference's
`remat`) is not ported: the backward keeps every layer's activations.
"""

from __future__ import annotations

import torch

from repro_torch.models import attention as A
from repro_torch.models import ffn as F
from repro_torch.models import layers as L
from repro_torch.models import ssm as S


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


def _unstack(tree, n):
    """The n per-layer trees of a stacked tree, as views. One unbind a
    leaf: its backward stacks the n layers' gradients once."""
    if isinstance(tree, dict):
        per_key = {k: _unstack(v, n) for k, v in tree.items()}
        return [{k: v[i] for k, v in per_key.items()} for i in range(n)]
    return tree.unbind(0)


def stack_apply(params, x, cfg, *, caches=None, cache_pos=None,
                kv_table=None):
    """Returns (x, caches). Without caches this is the training forward
    (cache-less causal attention). kv_table (paged decode) has no layer
    dim: a logical page is the same physical page in every layer's pool,
    so every layer gets the same table."""
    n = params["attn_norm"]["scale"].shape[0]
    layers = _unstack(params, n)
    per_cache = [None] * n if caches is None else _unstack(caches, n)
    for i in range(n):
        x, _ = block_apply(layers[i], x, cfg, cache=per_cache[i],
                           cache_pos=cache_pos, kv_table=kv_table)
    return x, caches


# ----------------------------------------------------------------------
# Mamba-2 stack
# ----------------------------------------------------------------------

def ssm_stack_init(generator, cfg, *, device):
    layers = [{"norm": _norm_init(cfg, device),
               "mamba": S.mamba_init(generator, cfg, device=device)}
              for _ in range(cfg.n_layers)]
    return _stack(layers)


def ssm_stack_apply(params, x, cfg, *, states=None, decode=False):
    """Returns (x, states). states: stacked Mamba states (leading layer
    dim). decode: x is one token a row, and each layer steps its state
    from `states`; otherwise the full-sequence pass, which starts from a
    zero state and, given `states`, writes the state it ends in there.
    States are updated in place."""
    n = params["norm"]["scale"].shape[0]
    layers = _unstack(params, n)
    per_state = [None] * n if states is None else _unstack(states, n)
    for i in range(n):
        xin = L.rmsnorm_apply(layers[i]["norm"], x)
        if decode:
            h, new = S.mamba_decode(layers[i]["mamba"], xin, cfg, per_state[i])
        else:
            h, new = S.mamba_apply(layers[i]["mamba"], xin, cfg,
                                   return_state=states is not None)
        if new is not None:
            for k, v in new.items():
                per_state[i][k].copy_(v)
        x = x + h
    return x, states
