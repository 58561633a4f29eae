"""Top-level model API of the port, families `dense`, `vlm`, `moe`, `ssm`,
`hybrid` and `encdec`:

    params = init_params(cfg, generator, device)
    qparams = quantize_params(params)          # int8 dense weights
    cache = init_cache(cfg, batch_size, max_len, device)
    pcache = init_paged_cache(cfg, n_pages, page_size, max_slots,
                              pages_per_slot, quant_kv=..., device=...)
    logits, cache = prefill(cfg, params, batch, cache)
    logits, cache = decode_step(cfg, params, token, pos, cache)   # or pcache
    logits, cache = verify_step(cfg, params, tokens, pos, n_tok, cache)
    logits = forward(cfg, params, batch)                # training
    loss, metrics = loss_fn(cfg, params, batch)         # differentiable

A batch is {"tokens": (B, T)}, with "labels" for loss_fn, and may carry
"positions", the tokens' RoPE positions, (B, T) or, for vlm, the
(B, T, 3) (t, h, w) M-RoPE streams; the cache is written at `pos` all
the same. A vlm batch may carry "patch_embeds" (B, T, d_model), the
stub vision frontend's output aligned with the tokens (zeros at text
positions), added to the token embeddings. vlm decode and verify steps
turn a text token at position p by t = h = w = p, built from the
position tensor the step reads (so a captured step takes its positions
from that tensor at every replay).

Params carry the keys, shapes, scales and param_dtype of the JAX
package's `init_params`; `repro_torch.bridge` converts those leaf for
leaf. Caches are updated in place (see models.attention). The vlm
family (Qwen2-VL's text decoder) is the dense family's stack with QKV
biases and M-RoPE, on the same caches and steps. The moe family
(Mixtral, Arctic) is the dense family's stack with a mixture-of-experts
FFN in each block (models.moe), on the same caches and steps; its
router losses come from `forward(..., aux={})`. The ssm
family's cache is its recurrent state: the SSD state and the two conv
tails of every layer. The hybrid family (Zamba2) keeps that state for
each Mamba layer, stacked (n_seg, attn_every, B, ...), beside the
shared attention block's KV cache of each segment, (n_seg, B, Tmax,
Hkv, Dh). Both serve (prefill, decode_step) on dense caches, with float
or int8 weights; the page pool and the verify step are the KV
families' only. Every family trains (forward, loss_fn), each layer
rematerialised in the backward as `cfg.remat` says (models.transformer):
a moe loss carries its router losses, an encdec batch its frames.

The encdec family (Whisper) takes a batch's "enc_frames" (B, enc_ctx,
d_model), the stub conv frontend's output, through a bidirectional
layernorm encoder (`_run_encoder`: frames plus sinusoid positions) and
a causal decoder (token embeddings plus sinusoid positions, no RoPE)
whose blocks attend the encoder's output. Its cache is {"self": the
decoder's KV cache, "cross": each decoder layer's projection of the
encoder's output, {"k", "v"}: (L, B, enc_ctx, Hkv, Dh)}: `prefill` runs
the encoder and writes "cross" in place; a decode step reads it, each
slot's row through the decode kernel at its last key (`cross_pos`). It
serves on dense caches with float or int8 weights; neither a page pool
nor a verify step takes its read-only whole-sequence cross cache.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch

from repro_torch.core import distributed as D
from repro_torch.core.device import resolve_device
from repro_torch.distributed import context as ctx
from repro_torch.distributed import sharding as SH
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import ssm as S
from repro_torch.models import transformer as T


#: The families whose cache is attention KV alone: they take a page pool
#: and a verify step.
KV_FAMILIES = ("dense", "vlm", "moe")


#: Why a family other than the KV_FAMILIES takes neither a page pool nor
#: a verify step.
_NOT_KV = {"ssm": "keeps a recurrent state",
           "hybrid": "keeps a recurrent state",
           "encdec": "reads a cross cache, the encoder's K/V of each "
                     "request, read-only and whole-sequence"}


def _check_family(cfg) -> None:
    hybrid = (cfg.family == "hybrid" and cfg.ssm is not None
              and cfg.mlp == "swiglu" and cfg.attn_every > 0
              and cfg.n_layers % cfg.attn_every == 0)
    kv = cfg.family in KV_FAMILIES and cfg.mlp == "swiglu" \
        and (cfg.moe is not None) == (cfg.family == "moe")
    rms = cfg.norm == "rms" and (
        kv or (cfg.family == "ssm" and cfg.ssm is not None) or hybrid)
    encdec = (cfg.family == "encdec" and cfg.norm == "ln"
              and cfg.mlp == "gelu" and cfg.moe is None and cfg.ssm is None
              and cfg.n_enc_layers > 0 and cfg.enc_ctx > 0)
    if not (rms or encdec):
        raise ValueError(f"the port serves dense, vlm and moe swiglu/rms "
                         f"decoders, rms Mamba-2 stacks (ssm), Mamba-2 "
                         f"stacks in whole segments with a shared swiglu "
                         f"block (hybrid) and layernorm/gelu "
                         f"encoder-decoders with encoder layers and frames "
                         f"(encdec), not {cfg.name} ({cfg.family}, norm "
                         f"{cfg.norm!r}, mlp {cfg.mlp!r})")


def _enc_cfg(cfg):
    """An encoder-decoder's encoder stack as a config of its own depth
    (its init scales and remat read n_layers)."""
    return dataclasses.replace(cfg, n_layers=cfg.n_enc_layers)


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
    elif cfg.family == "hybrid":
        p["hybrid"] = T.hybrid_init(generator, cfg, device=device)
    elif cfg.family == "encdec":
        p["enc_layers"] = T.stack_init(generator, _enc_cfg(cfg),
                                       device=device)
        p["enc_final_norm"] = T._norm_init(cfg, device)
        p["dec_layers"] = T.stack_init(generator, cfg, device=device,
                                       cross=True)
    else:
        p["layers"] = T.stack_init(generator, cfg, device=device)
    return p


#: Param subtrees never quantized: the embedding is gathered, and the
#: tied logits attend through it; the MoE router is a small f32 GEMM whose
#: top-k decides the routing, so a quantization step there would reroute
#: tokens.
QUANT_EXCLUDE = ("embed", "router")


def quantize_params(params):
    """Every dense-layer weight dict ({"w": 2D or stacked 3D float,
    "b"?}) outside QUANT_EXCLUDE becomes {"w_q", "w_scale", "b"?}
    (layers.dense_quantize); dense_apply / gated_apply then route those
    layers through core.gemm.dense_q. Quantize the f32 params, before
    any cast, as the JAX engine does. As the JAX package's walk: a
    mamba2 model's 3D stacks and lm_head are quantized; a hybrid's
    (n_seg, attn_every, K, N) Mamba stacks are 4D and stay float, so
    its shared block, the block's input projection and lm_head are;
    raw arrays (the hybrid's lora_a / lora_b, the MoE expert banks) stay
    float, and so does the f32 router; Arctic's dense branch is
    quantized; an encoder-decoder's encoder, decoder and cross-attention
    weights are, their biases kept float."""

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
    max_len. hybrid: {"mamba": that state with (n_seg, attn_every) in
    place of L, "attn": {"k", "v": (n_seg, B, max_len, Hkv, Dh)}}.
    encdec: {"self": the dense caches, "cross": {"k", "v": (L, B,
    enc_ctx, Hkv, Dh)}}."""
    device = resolve_device(device)
    dtype = getattr(torch, cfg.dtype)

    def kv(layers, length=max_len):
        shape = (layers, batch, length, cfg.n_kv_heads,
                 cfg.resolved_head_dim)
        return {"k": torch.zeros(shape, dtype=dtype, device=device),
                "v": torch.zeros(shape, dtype=dtype, device=device)}

    if cfg.family == "encdec":
        return {"self": kv(cfg.n_layers),
                "cross": kv(cfg.n_layers, cfg.enc_ctx)}

    if cfg.family in ("ssm", "hybrid"):
        st = S.mamba_init_state(cfg, batch, device=device, dtype=dtype)
        if cfg.family == "ssm":
            return {k: v.new_zeros((cfg.n_layers, *v.shape))
                    for k, v in st.items()}
        n_seg = cfg.n_layers // cfg.attn_every
        return {"mamba": {k: v.new_zeros((n_seg, cfg.attn_every, *v.shape))
                          for k, v in st.items()},
                "attn": kv(n_seg)}
    return kv(cfg.n_layers)


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
    if cfg.family not in KV_FAMILIES:
        raise ValueError(f"a paged KV cache serves the families "
                         f"{KV_FAMILIES}; {cfg.name} ({cfg.family}) "
                         f"{_NOT_KV[cfg.family]}")
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


def _embed_inputs(cfg, params, batch):
    """The token embeddings of batch["tokens"] in the compute dtype, plus
    a vlm batch's "patch_embeds" in that dtype."""
    dtype = getattr(torch, cfg.dtype)
    x = L.embed_apply(params["embed"], batch["tokens"], dtype=dtype)
    if cfg.family == "vlm" and "patch_embeds" in batch:
        x = x + batch["patch_embeds"].to(dtype)
    return x


def _text_positions(cfg, b: int, t: int, pos, device):
    """A vlm step's M-RoPE positions, (B, t, 3): t = h = w = pos (+ r for
    row r), from an int or a (B,) position tensor (no host sync); None
    for the other families, whose positions come from the cache's."""
    if cfg.family != "vlm" or cfg.mrope_sections is None:
        return None
    return L.default_positions(b, t, pos, device=device)[..., None] \
        .expand(b, t, 3)


def _run_encoder(cfg, params, frames):
    """The encoder's output (B, enc_ctx, d_model) for frames (B, enc_ctx,
    d_model): frames in the compute dtype plus sinusoid positions,
    bidirectional blocks, the final norm."""
    x = frames.to(getattr(torch, cfg.dtype))
    x = x + L.sinusoid_positions(x.shape[1], cfg.d_model,
                                 device=x.device)[None].to(x.dtype)
    x, _ = T.stack_apply(params["enc_layers"], x, _enc_cfg(cfg), causal=False)
    return T._norm_apply(cfg, params["enc_final_norm"], x)


def _cross_pos(pos, enc_len: int):
    """A decode step's cross-attention positions: each slot's query sees
    every encoder key, so its position is the last key's, enc_len - 1;
    an idle slot's (pos < 0) is -1, a zero row (no host sync)."""
    if isinstance(pos, torch.Tensor) and pos.dim() == 1:
        return torch.where(pos >= 0, enc_len - 1, -1).to(torch.int32)
    return enc_len - 1


def _check_mesh(cfg) -> None:
    """Refuse a family the port does not shard over the current mesh's
    "model" axis (`distributed.sharding.check_tp`)."""
    SH.check_tp(cfg, ctx.axis_size("model"))


def _logits(cfg, params, x, gather: bool = True):
    """f32 logits over the padded vocab, the pad classes masked to -1e30.
    Under a "model" group each rank computes its block of the vocab
    (column-parallel); gather=True joins the blocks (an all-gather), else
    the block comes back (`loss_fn`'s vocab-parallel cross entropy)."""
    x = T._norm_apply(cfg, params["final_norm"], x)
    group = ctx.model_group()
    if cfg.tie_embeddings:
        logits = L.embed_attend(params["embed"], x, gather=gather)
    else:
        logits = L.dense_apply(params["lm_head"], D.copy_to(x, group),
                               out_dtype=torch.float32)
        if gather:
            logits = D.gather_from(logits, group)
    if group is not None and not gather:
        n = logits.shape[-1]
        cls = D._rank(group) * n + torch.arange(n, device=logits.device)
        return torch.where(cls < cfg.vocab, logits, -1e30)
    if cfg.padded_vocab != cfg.vocab:
        logits[..., cfg.vocab:] = -1e30      # mask the pad classes
    return logits


def _vocab_parallel_nll(logits, labels, group):
    """-log softmax(logits)[labels] from each rank's block of the vocab:
    the max and the sum of exponentials over the vocab all-reduced, and
    the label's logit from the rank that holds it."""
    import torch.distributed as dist
    z = logits.float()
    m = z.detach().amax(dim=-1)
    dist.all_reduce(m, op=dist.ReduceOp.MAX, group=group)
    s = D.reduce_from(torch.exp(z - m[..., None]).sum(dim=-1), group)
    n = z.shape[-1]
    local = labels - D._rank(group) * n
    inside = (local >= 0) & (local < n)
    zt = z.gather(-1, local.clamp(0, n - 1)[..., None])[..., 0]
    zt = D.reduce_from(torch.where(inside, zt, 0.0), group)
    return torch.log(s) + m - zt


#: The families that `forward` and `loss_fn` train; the launcher offers
#: their archs but whisper-tiny, whose batches need encoder frames that
#: the synthetic token data does not carry (launch.train).
TRAIN_FAMILIES = ("dense", "vlm", "moe", "ssm", "hybrid", "encdec")


def forward(cfg, params, batch, aux=None, gather: bool = True):
    """Full-sequence f32 logits (B, T, padded_vocab) of batch["tokens"]
    (B, T), the pad classes masked to -1e30: the training forward, with
    cache-less causal attention (dense, vlm and moe, at
    batch["positions"] where given, and the hybrid's shared block) and
    the Mamba-2 layers' scans from a zero state (ssm, hybrid); encdec:
    the encoder over batch["enc_frames"], then the decoder at sinusoid
    positions 0 .. T - 1, its cross-attention over K/V projected from
    the encoder's output. aux: a dict that a moe model fills with the
    aux dict the JAX package's `forward` returns (its router losses and
    dropped fraction; empty for the other families), or None to compute
    none of it. gather: under a "model" group, False returns this rank's
    block of the vocab (`_logits`)."""
    _check_mesh(cfg)
    x = _embed_inputs(cfg, params, batch)
    if cfg.family == "encdec":
        enc_out = _run_encoder(cfg, params, batch["enc_frames"])
        x = x + L.sinusoid_positions(x.shape[1], cfg.d_model,
                                     device=x.device)[None].to(x.dtype)
        x, _ = T.stack_apply(params["dec_layers"], x, cfg, enc_out=enc_out)
    elif cfg.family == "ssm":
        x, _ = T.ssm_stack_apply(params["layers"], x, cfg)
    elif cfg.family == "hybrid":
        x, _, _ = T.hybrid_apply(params["hybrid"], x, cfg, emb0=x)
    else:
        x, _ = T.stack_apply(params["layers"], x, cfg,
                             positions=batch.get("positions"), aux=aux)
    return _logits(cfg, params, x, gather=gather)


def loss_fn(cfg, params, batch):
    """Mean next-token cross entropy over the labels >= 0 of
    batch["labels"] (B, T) (-1: no label), from an f32 log-softmax over
    the padded vocab, plus every aux term named *_loss (a moe model's
    router losses, summed over its layers), as the JAX package's
    `loss_fn` adds them. Returns (loss, {"ce_loss", "tokens", the aux
    terms ("moe_lb_loss", "moe_z_loss", "moe_dropped_frac" for moe),
    "loss"}). Under a "model" group the cross entropy is vocab-parallel
    (`_vocab_parallel_nll`): no rank holds the whole logits."""
    aux = {}
    group = ctx.model_group()
    logits = forward(cfg, params, batch, aux=aux, gather=group is None)
    labels = batch["labels"].long()
    valid = labels >= 0
    if group is None:
        logp = torch.log_softmax(logits.float(), dim=-1)
        nll = -logp.gather(-1, labels.clamp(min=0)[..., None])[..., 0]
    else:
        nll = _vocab_parallel_nll(logits, labels.clamp(min=0), group)
    denom = valid.sum().clamp(min=1)
    loss = (nll * valid).sum() / denom
    metrics = {"ce_loss": loss, "tokens": denom}
    for name, v in aux.items():
        metrics[name] = v
        if name.endswith("_loss"):
            loss = loss + v
    metrics["loss"] = loss
    return loss, metrics


def prefill(cfg, params, batch, cache, pos: int = 0):
    """Run the prompt batch["tokens"] (B, T) through the model, writing
    the cache from `pos` (dense and vlm: turned by batch["positions"]
    where given; ssm: the state the prompt ends in, which the prompt
    computes from a zero state; hybrid: that state and the shared
    block's KV rows; encdec: the encoder runs over batch["enc_frames"]
    (B, enc_ctx, d_model), each decoder layer's projection of its output
    is written into cache["cross"], and the decoder's KV rows into
    cache["self"]). Returns (last-position f32 logits, cache)."""
    _check_mesh(cfg)
    x = _embed_inputs(cfg, params, batch)
    if cfg.family == "encdec":
        enc_out = _run_encoder(cfg, params, batch["enc_frames"])
        cross = cache["cross"]
        layers = T._unstack(params["dec_layers"]["cross_attn"],
                            cfg.n_layers)
        for i, lp in enumerate(layers):
            k, v = A.project_cross_kv(lp, enc_out, cfg)
            cross["k"][i].copy_(k)
            cross["v"][i].copy_(v)
        x = x + L.sinusoid_positions(x.shape[1], cfg.d_model, pos,
                                     device=x.device)[None].to(x.dtype)
        x, _ = T.stack_apply(params["dec_layers"], x, cfg,
                             caches=cache["self"], cache_pos=pos,
                             cross_caches=cross)
    elif cfg.family == "ssm":
        x, cache = T.ssm_stack_apply(params["layers"], x, cfg, states=cache)
    elif cfg.family == "hybrid":
        x, _, _ = T.hybrid_apply(params["hybrid"], x, cfg, emb0=x,
                                 attn_caches=cache["attn"], cache_pos=pos,
                                 mamba_states=cache["mamba"])
    else:
        x, cache = T.stack_apply(params["layers"], x, cfg, caches=cache,
                                 cache_pos=pos,
                                 positions=batch.get("positions"))
    return _logits(cfg, params, x[:, -1:]), cache


def decode_step(cfg, params, token, pos, cache):
    """One-token step. token: (B, 1) int; pos: an int, or a (B,) per-slot
    position vector (pos < 0 marks an idle slot whose cache is left
    untouched and whose logits are garbage). `cache` is a dense cache
    (init_cache) or a paged one (init_paged_cache, which takes a per-slot
    pos). ssm: the state steps one token in every row; pos is not read,
    so an idle slot's row steps on garbage, which its next admission
    overwrites. hybrid: its Mamba state steps so, and its KV rows are
    written and read at pos as the dense family's. vlm: as dense, the
    token turned by t = h = w = pos. encdec: the token plus the
    sinusoid at pos (computed on the position tensor's device), its self
    KV rows as the dense family's, its cross-attention over each slot's
    cache["cross"] rows through the decode kernel (`_cross_pos`).
    Returns (f32 logits, cache)."""
    _check_mesh(cfg)
    x = L.embed_apply(params["embed"], token, dtype=getattr(torch, cfg.dtype))
    positions = _text_positions(cfg, token.shape[0], 1, pos, x.device)
    if cfg.family == "encdec":
        p = pos if isinstance(pos, torch.Tensor) \
            else torch.tensor(pos, device=x.device)
        pe = L.sinusoid_at(cfg.d_model, p).reshape(-1, 1, cfg.d_model)
        x = x + pe.to(x.dtype)
        x, _ = T.stack_apply(
            params["dec_layers"], x, cfg, caches=cache["self"],
            cache_pos=pos, cross_caches=cache["cross"],
            cross_pos=_cross_pos(pos, cache["cross"]["k"].shape[2]))
    elif cfg.family == "ssm":
        x, cache = T.ssm_stack_apply(params["layers"], x, cfg, states=cache,
                                     decode=True)
    elif cfg.family == "hybrid":
        x, _, _ = T.hybrid_apply(params["hybrid"], x, cfg, emb0=x,
                                 attn_caches=cache["attn"], cache_pos=pos,
                                 mamba_states=cache["mamba"], decode=True)
    elif "pages" in cache:
        # the layer-less table goes to every layer's pool
        x, _ = T.stack_apply(params["layers"], x, cfg, caches=cache["pages"],
                             cache_pos=pos, kv_table=cache["table"],
                             positions=positions)
    else:
        x, cache = T.stack_apply(params["layers"], x, cfg, caches=cache,
                                 cache_pos=pos, positions=positions)
    return _logits(cfg, params, x), cache


def verify_step(cfg, params, tokens, pos, n_tok, cache, drops=None):
    """A speculative verify step, one forward over t tokens a slot.

    tokens: (B, t) int, a slot's pending token and its draft proposals;
    pos: (B,) int tensor, the position of tokens[:, 0] (pos < 0: idle
    slot); n_tok: (B,) int tensor, the real tokens a slot: rows past it
    neither write the cache nor attend, and their logits rows are
    garbage. `cache` is a dense or a paged cache (int8 pages too),
    updated in place. Returns ((B, t, padded_vocab) f32 logits, cache):
    row j scores the token at pos + j + 1. Its attention is the decode
    kernel's multi-row form, so row j and the cache rows it writes are
    those of a decode step at pos + j, bit for bit, as its GEMMs' rows
    are at any row count. vlm: row j turned by t = h = w = pos + j. moe:
    the B * t tokens route as one group, where an expert's capacity can
    drop some of them, as the reference's verify step routes them (so a
    moe row is a decode step's only where nothing is dropped); drops: a
    list that a moe model appends each layer's (B, t) dropped
    assignments a token to. The KV families only, as the JAX package's
    `verify_step` refuses the others."""
    _check_mesh(cfg)
    if cfg.family not in KV_FAMILIES:
        raise ValueError(f"speculative verification needs an attention "
                         f"cache alone (families {KV_FAMILIES}), not "
                         f"{cfg.name} ({cfg.family}), which "
                         f"{_NOT_KV[cfg.family]}")
    x = L.embed_apply(params["embed"], tokens, dtype=getattr(torch, cfg.dtype))
    positions = _text_positions(cfg, *tokens.shape, pos, x.device)
    if "pages" in cache:
        x, _ = T.stack_apply(params["layers"], x, cfg, caches=cache["pages"],
                             cache_pos=pos, kv_table=cache["table"],
                             n_valid=n_tok, positions=positions, drops=drops)
    else:
        x, cache = T.stack_apply(params["layers"], x, cfg, caches=cache,
                                 cache_pos=pos, n_valid=n_tok,
                                 positions=positions, drops=drops)
    return _logits(cfg, params, x), cache
