"""Top-level model API of the port, family `dense`:

    params = init_params(cfg, generator, device)
    cache = init_cache(cfg, batch_size, max_len, device)
    logits, cache = prefill(cfg, params, batch, cache)
    logits, cache = decode_step(cfg, params, token, pos, cache)

Params carry the keys, shapes, scales and param_dtype of the JAX
package's `init_params`; `repro_torch.bridge` converts those leaf for
leaf. Caches are updated in place (see models.attention).
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.core.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import transformer as T


def _check_family(cfg) -> None:
    if cfg.family != "dense" or cfg.mlp != "swiglu" or cfg.norm != "rms":
        raise ValueError(f"the port serves dense swiglu/rms decoders, not "
                         f"{cfg.name} ({cfg.family})")


def init_params(cfg, generator: torch.Generator, device=None) -> Dict[str, Any]:
    """Random params drawn from `generator` (normal, scaled as the JAX
    package scales them), placed on `device`."""
    _check_family(cfg)
    device = resolve_device(device)
    dtype = getattr(torch, cfg.param_dtype)
    p: Dict[str, Any] = {
        "embed": L.embed_init(generator, cfg.padded_vocab, cfg.d_model,
                              dtype=dtype, device=device),
        "final_norm": T._norm_init(cfg, device),
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = L.dense_init(generator, cfg.d_model, cfg.padded_vocab,
                                    dtype=dtype, device=device)
    p["layers"] = T.stack_init(generator, cfg, device=device)
    return p


def init_cache(cfg, batch: int, max_len: int, device=None):
    device = resolve_device(device)
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.resolved_head_dim)
    dtype = getattr(torch, cfg.dtype)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _logits(cfg, params, x):
    x = L.rmsnorm_apply(params["final_norm"], x)
    if cfg.tie_embeddings:
        logits = L.embed_attend(params["embed"], x)
    else:
        logits = L.dense_apply(params["lm_head"], x, out_dtype=torch.float32)
    if cfg.padded_vocab != cfg.vocab:
        logits[..., cfg.vocab:] = -1e30      # mask the pad classes
    return logits


def prefill(cfg, params, batch, cache, pos: int = 0):
    """Run the prompt batch["tokens"] (B, T) through the model, writing
    the cache from `pos`. Returns (last-position f32 logits, cache)."""
    x = L.embed_apply(params["embed"], batch["tokens"],
                      dtype=getattr(torch, cfg.dtype))
    x, cache = T.stack_apply(params["layers"], x, cfg, caches=cache,
                             cache_pos=pos)
    return _logits(cfg, params, x[:, -1:]), cache


def decode_step(cfg, params, token, pos, cache):
    """One-token step. token: (B, 1) int; pos: an int, or a (B,) per-slot
    position vector (pos < 0 marks an idle slot whose cache is left
    untouched and whose logits are garbage). Returns (f32 logits, cache)."""
    x = L.embed_apply(params["embed"], token, dtype=getattr(torch, cfg.dtype))
    x, cache = T.stack_apply(params["layers"], x, cfg, caches=cache,
                             cache_pos=pos)
    return _logits(cfg, params, x), cache
