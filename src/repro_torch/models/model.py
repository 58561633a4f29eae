"""Top-level model API of the port, families `dense` and `ssm`:

    params = init_params(cfg, generator, device)
    qparams = quantize_params(params)          # int8 dense weights
    cache = init_cache(cfg, batch_size, max_len, device)
    pcache = init_paged_cache(cfg, n_pages, page_size, max_slots,
                              pages_per_slot, quant_kv=..., device=...)
    logits, cache = prefill(cfg, params, batch, cache)
    logits, cache = decode_step(cfg, params, token, pos, cache)   # or pcache
    logits = forward(cfg, params, batch)                # training
    loss, metrics = loss_fn(cfg, params, batch)         # differentiable

Params carry the keys, shapes, scales and param_dtype of the JAX
package's `init_params`; `repro_torch.bridge` converts those leaf for
leaf. Caches are updated in place (see models.attention). The ssm
family's cache is its recurrent state: the SSD state and the two conv
tails of every layer. It serves (prefill, decode_step) on a dense
state: the page pool, int8 weights and training (forward, loss_fn) are
the dense family's only.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.core.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import ssm as S
from repro_torch.models import transformer as T


def _check_family(cfg) -> None:
    if cfg.norm != "rms" or not (
            (cfg.family == "dense" and cfg.mlp == "swiglu")
            or (cfg.family == "ssm" and cfg.ssm is not None)):
        raise ValueError(f"the port serves dense swiglu/rms decoders and "
                         f"rms Mamba-2 stacks (ssm), not {cfg.name} "
                         f"({cfg.family})")


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
    if cfg.family == "ssm":
        p["layers"] = T.ssm_stack_init(generator, cfg, device=device)
    else:
        p["layers"] = T.stack_init(generator, cfg, device=device)
    return p


#: Param subtrees never quantized: the embedding is gathered, and the
#: tied logits attend through it (the router has no served arch yet).
QUANT_EXCLUDE = ("embed", "router")


def quantize_params(params):
    """Every dense-layer weight dict ({"w": 2D or stacked 3D float,
    "b"?}) outside QUANT_EXCLUDE becomes {"w_q", "w_scale", "b"?}
    (layers.dense_quantize); dense_apply / gated_apply then route those
    layers through core.gemm.dense_q. Quantize the f32 params, before
    any cast, as the JAX engine does. int8 weights on the ssm family are
    not ported."""
    if "mamba" in params.get("layers", {}):
        raise NotImplementedError("int8 weights are ported for the dense "
                                  "family only, not for Mamba-2 (ssm) params")

    def rec(node, name):
        if isinstance(node, dict):
            w = node.get("w")
            if (isinstance(w, torch.Tensor) and w.dim() in (2, 3)
                    and name not in QUANT_EXCLUDE and w.is_floating_point()):
                return L.dense_quantize(node)
            return {k: rec(v, k) for k, v in node.items()}
        return node

    return rec(params, "")


def init_cache(cfg, batch: int, max_len: int, device=None):
    """Dense: the (L, B, max_len, Hkv, Dh) K and V caches. ssm: each
    layer's recurrent state, {"ssd": (L, B, H, P, N) f32, "conv":
    (L, B, W - 1, d_inner), "conv_bc": (L, B, W - 1, 2GN)}, whatever
    max_len."""
    device = resolve_device(device)
    if cfg.family == "ssm":
        st = S.mamba_init_state(cfg, batch, device=device,
                                dtype=getattr(torch, cfg.dtype))
        return {k: v.new_zeros((cfg.n_layers, *v.shape))
                for k, v in st.items()}
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.resolved_head_dim)
    dtype = getattr(torch, cfg.dtype)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def init_paged_cache(cfg, n_pages: int, page_size: int, max_slots: int,
                     pages_per_slot: int, *, quant_kv: str = "off",
                     device=None):
    """Page-pool KV cache for continuous-batching decode (the host-side
    bookkeeping is serving.kv_pool). Layout:

        {"pages": {"k", "v": (L, n_pages, page_size, Hkv, Dh)
                   [, "ks", "vs": (L, n_pages, Hkv, page_size) f32]},
         "table": (max_slots, pages_per_slot) int32, -1 = unmapped}

    quant_kv="int8" stores int8 pages with per-(position, head) f32
    scale planes; the decode kernel dequantizes on f32."""
    _check_family(cfg)
    if cfg.family != "dense":
        raise ValueError(f"a paged KV cache is for attention caches; "
                         f"{cfg.name} ({cfg.family}) keeps a recurrent state")
    device = resolve_device(device)
    hkv, dh = cfg.n_kv_heads, cfg.resolved_head_dim
    shape = (cfg.n_layers, n_pages, page_size, hkv, dh)
    if quant_kv == "int8":
        planes = (cfg.n_layers, n_pages, hkv, page_size)
        pages = {"k": torch.zeros(shape, dtype=torch.int8, device=device),
                 "v": torch.zeros(shape, dtype=torch.int8, device=device),
                 "ks": torch.zeros(planes, dtype=torch.float32, device=device),
                 "vs": torch.zeros(planes, dtype=torch.float32, device=device)}
    elif quant_kv == "off":
        dtype = getattr(torch, cfg.dtype)
        pages = {"k": torch.zeros(shape, dtype=dtype, device=device),
                 "v": torch.zeros(shape, dtype=dtype, device=device)}
    else:
        raise ValueError(f"unknown quant_kv {quant_kv!r}")
    return {"pages": pages,
            "table": torch.full((max_slots, pages_per_slot), -1,
                                dtype=torch.int32, device=device)}


def _logits(cfg, params, x):
    x = L.rmsnorm_apply(params["final_norm"], x)
    if cfg.tie_embeddings:
        logits = L.embed_attend(params["embed"], x)
    else:
        logits = L.dense_apply(params["lm_head"], x, out_dtype=torch.float32)
    if cfg.padded_vocab != cfg.vocab:
        logits[..., cfg.vocab:] = -1e30      # mask the pad classes
    return logits


def forward(cfg, params, batch):
    """Full-sequence f32 logits (B, T, padded_vocab) of batch["tokens"]
    (B, T), the pad classes masked to -1e30: the training forward, with
    cache-less causal attention. (The JAX package's `forward` also
    returns an aux dict, which is empty for the dense family.)"""
    if cfg.family != "dense":
        raise NotImplementedError(f"training (forward, loss_fn) is ported for "
                                  f"the dense family only, not {cfg.name} "
                                  f"({cfg.family})")
    x = L.embed_apply(params["embed"], batch["tokens"],
                      dtype=getattr(torch, cfg.dtype))
    x, _ = T.stack_apply(params["layers"], x, cfg)
    return _logits(cfg, params, x)


def loss_fn(cfg, params, batch):
    """Mean next-token cross entropy over the labels >= 0 of
    batch["labels"] (B, T) (-1: no label), from an f32 log-softmax over
    the padded vocab. Returns (loss, {"ce_loss", "tokens", "loss"})."""
    logits = forward(cfg, params, batch)
    labels = batch["labels"].long()
    valid = labels >= 0
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(-1, labels.clamp(min=0)[..., None])[..., 0]
    denom = valid.sum().clamp(min=1)
    loss = (nll * valid).sum() / denom
    return loss, {"ce_loss": loss, "tokens": denom, "loss": loss}


def prefill(cfg, params, batch, cache, pos: int = 0):
    """Run the prompt batch["tokens"] (B, T) through the model, writing
    the cache from `pos` (ssm: the state the prompt ends in, which the
    prompt computes from a zero state). Returns (last-position f32
    logits, cache)."""
    x = L.embed_apply(params["embed"], batch["tokens"],
                      dtype=getattr(torch, cfg.dtype))
    if cfg.family == "ssm":
        x, cache = T.ssm_stack_apply(params["layers"], x, cfg, states=cache)
    else:
        x, cache = T.stack_apply(params["layers"], x, cfg, caches=cache,
                                 cache_pos=pos)
    return _logits(cfg, params, x[:, -1:]), cache


def decode_step(cfg, params, token, pos, cache):
    """One-token step. token: (B, 1) int; pos: an int, or a (B,) per-slot
    position vector (pos < 0 marks an idle slot whose cache is left
    untouched and whose logits are garbage). `cache` is a dense cache
    (init_cache) or a paged one (init_paged_cache, which takes a per-slot
    pos). ssm: the state steps one token in every row; pos is not read,
    so an idle slot's row steps on garbage, which its next admission
    overwrites. Returns (f32 logits, cache)."""
    x = L.embed_apply(params["embed"], token, dtype=getattr(torch, cfg.dtype))
    if cfg.family == "ssm":
        x, cache = T.ssm_stack_apply(params["layers"], x, cfg, states=cache,
                                     decode=True)
    elif "pages" in cache:
        # the layer-less table goes to every layer's pool
        x, _ = T.stack_apply(params["layers"], x, cfg, caches=cache["pages"],
                             cache_pos=pos, kv_table=cache["table"])
    else:
        x, cache = T.stack_apply(params["layers"], x, cfg, caches=cache,
                                 cache_pos=pos)
    return _logits(cfg, params, x), cache
