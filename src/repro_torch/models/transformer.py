"""The layer stacks: pre-norm blocks of attention and a SwiGLU MLP
(family dense) or a mixture-of-experts FFN (family moe, `models.moe`),
pre-norm Mamba-2 blocks (family ssm), Zamba2's Mamba-2 backbone with
one shared attention block (family hybrid), and Whisper's layernorm
blocks with a gelu MLP (family encdec): a bidirectional encoder stack
(`causal=False`) and a causal decoder stack whose blocks add
cross-attention over the encoder's output (`block_init(cross=True)`).

Params are stacked with a leading layer dim, as the JAX package's
`stack_init` builds them, and `stack_apply` loops over that dim in
Python where the reference scans. The stacked leaves stay the leaves of
the param tree: layer i works on views of row i, so a gradient comes back
as one tensor per stacked leaf, as the reference's scan gives it. Caches
keep their (L, B, T, Hkv, D) layout (page pools their (L, P, page_size,
Hkv, D) one), updated in place.

Rematerialisation follows the reference's `remat` (`_maybe_remat`): with
`cfg.remat == "full"` each block of `stack_apply` (dense, vlm and moe;
an encoder-decoder's encoder and decoder blocks), each Mamba-2 layer of
the ssm stack and each Mamba-2 layer inside a hybrid segment (not the
shared block) runs under `torch.utils.checkpoint` when autograd records it, so
the backward keeps only each layer's input and runs the layer's forward
again, the same kernels on the same inputs, before its backward. A moe
block's router losses come back from the checkpointed body beside its
output and are summed outside it, as the reference carries (x, aux)
through its checkpointed scan body, so a recompute adds nothing twice;
an encoder-decoder's decoder blocks read the encoder's output by
closure, which the non-reentrant checkpoint differentiates. A call
that autograd does not record (serving, the engine's CUDA-graph
captures) never goes through it.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.core import gemm
from repro_torch.core.tree import leaves, tree_map
from repro_torch.models import attention as A
from repro_torch.models import ffn as F
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models import ssm as S


def _maybe_remat(fn, cfg, params):
    """fn, or fn under activation checkpointing where cfg.remat is "full"
    and autograd records a call on `params` (grad enabled, a leaf that
    requires grad): the counterpart of the reference's `jax.checkpoint`
    of a layer body, which saves nothing inside it."""
    if cfg.remat == "none" or not (torch.is_grad_enabled() and any(
            t.requires_grad for t in leaves(params))):
        return fn
    return lambda *args: checkpoint(fn, *args, use_reentrant=False,
                                    preserve_rng_state=False)


def _norm_init(cfg, device):
    dtype = getattr(torch, cfg.param_dtype)
    if cfg.norm == "ln":
        return L.layernorm_init(cfg.d_model, dtype=dtype, device=device)
    return L.rmsnorm_init(cfg.d_model, dtype=dtype, device=device)


def _norm_apply(cfg, p, x):
    if cfg.norm == "ln":
        return L.layernorm_apply(p, x)
    return L.rmsnorm_apply(p, x)


def block_init(generator, cfg, *, device, banks=True, cross=False):
    """banks=False: a moe block without its expert banks (`stack_init`
    draws them stacked). cross: a decoder block of an encoder-decoder,
    with cross-attention and its norm."""
    p = {
        "attn_norm": _norm_init(cfg, device),
        "attn": A.attn_init(generator, cfg, device=device),
        "mlp_norm": _norm_init(cfg, device),
    }
    if cfg.moe is not None:
        p["moe"] = M.moe_init(generator, cfg, device=device, banks=banks)
    else:
        p["mlp"] = F.mlp_init(generator, cfg, device=device)
    if cross:
        p["cross_norm"] = _norm_init(cfg, device)
        p["cross_attn"] = A.attn_init(generator, cfg, device=device)
    return p


def block_apply(p, x, cfg, *, cache=None, cache_pos=None, kv_table=None,
                n_valid=None, positions=None, aux=None, causal=True,
                enc_out=None, cross_cache=None, cross_pos=None, drops=None):
    """Returns (x, cache). positions: RoPE positions (attn_apply); aux: a
    dict a moe block adds its router losses into, drops: a list it
    appends its tokens' dropped assignments to (models.moe); causal:
    False in an encoder. A decoder block of an encoder-decoder attends
    the encoder after its self-attention: over `cross_cache`'s {"k", "v"}
    (prefill and decode), or over K/V projected from `enc_out` (the
    training forward); cross_pos: a decode step's (attn_apply)."""
    h, cache = A.attn_apply(p["attn"], _norm_apply(cfg, p["attn_norm"], x),
                            cfg, cache=cache, cache_pos=cache_pos,
                            kv_table=kv_table, n_valid=n_valid,
                            positions=positions, causal=causal)
    x = x + h
    if enc_out is not None or cross_cache is not None:
        kv = (cross_cache["k"], cross_cache["v"]) if cross_cache is not None \
            else A.project_cross_kv(p["cross_attn"], enc_out, cfg)
        hc, _ = A.attn_apply(p["cross_attn"],
                             _norm_apply(cfg, p["cross_norm"], x), cfg,
                             enc_kv=kv, cross_pos=cross_pos)
        x = x + hc
    if cfg.moe is not None:
        # added after the MoE, as the reference adds it (no flush to ride)
        return x + M.moe_apply(p["moe"], _norm_apply(cfg, p["mlp_norm"], x),
                               cfg, aux=aux, drops=drops), cache
    # the skip connection rides the down-projection's flush (residual)
    out = F.mlp_apply(p["mlp"], _norm_apply(cfg, p["mlp_norm"], x), cfg,
                      residual=x)
    return out, cache


def stack_init(generator, cfg, *, device, cross=False):
    """The layers' params stacked; a moe stack's expert banks are drawn
    stacked after the rest (`moe.bank_init`), never copied. cross: an
    encoder-decoder's decoder blocks (`block_init`)."""
    layers = [block_init(generator, cfg, device=device, banks=False,
                         cross=cross)
              for _ in range(cfg.n_layers)]
    p = _stack(layers)
    if cfg.moe is not None:
        p["moe"].update(M.bank_init(generator, cfg, device=device,
                                    n_layers=cfg.n_layers))
    return p


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
                kv_table=None, n_valid=None, positions=None, aux=None,
                causal=True, enc_out=None, cross_caches=None,
                cross_pos=None, drops=None):
    """Returns (x, caches). Without caches this is the training forward
    (cache-less attention, causal unless `causal=False`: an encoder).
    kv_table (paged decode) has no layer dim: a logical page is the same
    physical page in every layer's pool, so every layer gets the same
    table. n_valid: a verify step's real tokens a slot; positions: the
    tokens' RoPE positions, (B, T) or (B, T, 3), None for the default
    (models.attention.attn_apply). aux: a dict that a moe stack fills
    with its router losses summed over the layers and the dropped
    fraction averaged over them, as the reference's stack returns them;
    drops: a list that a moe stack appends each layer's (B, T) dropped
    assignments a token to (a cached step's: a recompute under remat
    would append again).
    An encoder-decoder's decoder stack attends the encoder through
    `cross_caches` (stacked {"k", "v"} (L, B, Tenc, Hkv, Dh), one layer's
    rows each) or `enc_out`, and `cross_pos` (`block_apply`)."""
    n = params["attn_norm"]["scale"].shape[0]
    layers = _unstack(params, n)
    per_cache = [None] * n if caches is None else _unstack(caches, n)
    per_cross = [None] * n if cross_caches is None \
        else _unstack(cross_caches, n)

    def body(lp, xc, cache, cross):
        # the layer's aux terms come back beside x, from a dict of this
        # call's own: a recompute under remat fills one that nobody reads
        layer_aux = None if aux is None else {}
        xo = block_apply(lp, xc, cfg, cache=cache, cache_pos=cache_pos,
                         kv_table=kv_table, n_valid=n_valid,
                         positions=positions, aux=layer_aux, causal=causal,
                         enc_out=enc_out, cross_cache=cross,
                         cross_pos=cross_pos, drops=drops)[0]
        return xo, layer_aux

    if caches is None:
        body = _maybe_remat(body, cfg, params)
    for i in range(n):
        x, layer_aux = body(layers[i], x, per_cache[i], per_cross[i])
        for name, v in (layer_aux or {}).items():
            aux[name] = aux[name] + v if name in aux else v
    if aux is not None and "moe_dropped_frac" in aux:
        aux["moe_dropped_frac"] = aux["moe_dropped_frac"] / cfg.n_layers
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

    def body(lp, xc, state):
        xin = L.rmsnorm_apply(lp["norm"], xc)
        if decode:
            h, new = S.mamba_decode(lp["mamba"], xin, cfg, state)
        else:
            h, new = S.mamba_apply(lp["mamba"], xin, cfg,
                                   return_state=states is not None)
        return xc + h, new

    if not decode:
        body = _maybe_remat(body, cfg, params)
    for i in range(n):
        x, new = body(layers[i], x, per_state[i])
        if new is not None:
            for k, v in new.items():
                per_state[i][k].copy_(v)
    return x, states


# ----------------------------------------------------------------------
# Zamba2 hybrid stack
# ----------------------------------------------------------------------

def hybrid_init(generator, cfg, *, device):
    """The Mamba layers stacked as (n_seg, attn_every, ...), one shared
    block with its 2d -> d input projection, and each segment's LoRA pair
    (lora_b zeros, as the JAX package initialises it)."""
    n_seg = cfg.n_layers // cfg.attn_every
    dtype = getattr(torch, cfg.param_dtype)
    mamba = tree_map(
        lambda a: a.reshape(n_seg, cfg.attn_every, *a.shape[1:]),
        ssm_stack_init(generator, cfg, device=device))
    p = {"mamba": mamba,
         "shared": {"in_proj": L.dense_init(generator, 2 * cfg.d_model,
                                            cfg.d_model, dtype=dtype,
                                            device=device),
                    "block": block_init(generator, cfg, device=device)}}
    r = cfg.shared_attn_lora_rank
    if r:
        a = torch.randn((n_seg, cfg.d_model, r), generator=generator,
                        dtype=torch.float32, device=generator.device)
        p["lora_a"] = (a * cfg.d_model ** -0.5).to(device=device, dtype=dtype)
        p["lora_b"] = torch.zeros(
            (n_seg, r, cfg.n_heads * cfg.resolved_head_dim), dtype=dtype,
            device=device)
    return p


def hybrid_apply(params, x, cfg, *, emb0, attn_caches=None, cache_pos=None,
                 mamba_states=None, decode=False):
    """Returns (x, attn_caches, mamba_states). Each segment runs its
    attn_every Mamba layers (`ssm_stack_apply`: prefill, collecting the
    states into `mamba_states` when given, or a decode step from them),
    then the shared block on in_proj(cat([x, emb0])), emb0 the embedding
    of this call's tokens, plus the segment's LoRA delta
    rmsnorm(attn_norm, xin) @ lora_a[s] @ lora_b[s]; the block's output
    (which carries xin) is added to x, as the reference adds it.
    attn_caches: stacked (n_seg, B, Tmax, Hkv, Dh) KV caches, written at
    cache_pos as `block_apply` writes them; both caches in place."""
    n_seg = cfg.n_layers // cfg.attn_every
    segs = _unstack(params["mamba"], n_seg)
    states = [None] * n_seg if mamba_states is None \
        else _unstack(mamba_states, n_seg)
    caches = [None] * n_seg if attn_caches is None \
        else _unstack(attn_caches, n_seg)
    shared = params["shared"]
    bp = shared["block"]
    for s in range(n_seg):
        x, _ = ssm_stack_apply(segs[s], x, cfg, states=states[s],
                               decode=decode)
        xin = L.dense_apply(shared["in_proj"], torch.cat([x, emb0], dim=-1))
        xo, _ = block_apply(bp, xin, cfg, cache=caches[s],
                            cache_pos=cache_pos)
        if cfg.shared_attn_lora_rank:
            # (xn @ a) @ b, the order XLA contracts the reference's
            # three-operand einsum in, each product rounded to xin's dtype
            xn = L.rmsnorm_apply(bp["attn_norm"], xin)
            xo = xo + gemm.matmul(
                gemm.matmul(xn, params["lora_a"][s].to(xin.dtype)),
                params["lora_b"][s].to(xin.dtype))
        x = x + xo
    return x, attn_caches, mamba_states
