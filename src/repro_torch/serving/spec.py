"""Speculative decoding: the draft half of the draft/verify engine (the
JAX package's `repro/serving/spec.py`).

A cheap draft model proposes `spec_k` tokens a slot a round; the target
scores all k + 1 positions in one forward (`models.model.verify_step`),
and the leftover/residual acceptance rule
(`sampler.Sampler.speculative_accept`) keeps the emitted stream the
target's distribution, and under greedy sampling the target's own
tokens.

`SpecDecoder` owns the draft side:

* the draft's params and its own DENSE per-slot cache, as long as the
  engine's (a round writes rows pos .. pos + k_vec, and the engine's
  k_vec leaves them inside a request's own length). The same length
  matters on the card: a prefill's attention over a cache shorter than
  `attn_chunk` reduces over every row of it, so a draft cache of
  another length would prefill the same prompt to other bits, and a
  self-draft would propose other tokens than its target's;
* `admit(slot, ctx)`: the slot's context prefilled into that cache,
  bucketed as the engine's admission is (a prefill of a multiple of
  `prefill_chunk` tokens, the rest one token at a time);
* `draft_round`: spec_k + 1 one-token draft steps over all slots, each
  row sampled on the host as the JAX package samples it.

Rollback is positional. A round at pos feeds (pending, d_1 .. d_k) at
pos .. pos + k, so draft rows pos .. pos + a hold the accepted tokens
for any acceptance count a. The rows past the new pending position are
stale: never attended (each step attends up to its own position) and
overwritten by the next round before they could be read. The engine's
target cache rests on the same rule after a rejection.

On the card the draft's decode step and its remainder step are CUDA
graphs (`steps.CapturedStep`) captured at construction, as the engine's
are; on the CPU they are the plain functions. `quant="int8"` quantizes
the draft's weights once, at construction (`models.model.
quantize_params`), so its steps and its prefill run the int8-weight GEMM;
its KV cache stays dense, as the JAX package's draft policy requires.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from repro_torch.core.device import resolve_device
from repro_torch.models import model as M
from repro_torch.serving.sampler import Sampler
from repro_torch.serving.steps import CapturedStep, on_device, place_params

__all__ = ["SpecDecoder"]


class SpecDecoder:
    """Draft-model runner for speculative decoding.

    cfg, params:  the DRAFT model (a dense or vlm config whose vocab is
                  the target's; the engine checks that).
    max_slots:    the engine's slot count (slot ids are shared).
    max_len:      the engine's (rounded) max_len, the draft cache's
                  length (rounded up to the draft's `attn_chunk` where
                  it is longer than that and not a multiple of it).
    spec_k:       draft tokens proposed a round.
    sampler:      the draft's proposal sampler (default greedy: a greedy
                  draft is a valid q under any target sampler, the delta
                  at its argmax).
    quant:        "off", or "int8": the draft's weights quantized once
                  (the embedding stays in the compute dtype).
    """

    def __init__(self, cfg, params, *, max_slots: int, max_len: int,
                 spec_k: int = 4, sampler: Optional[Sampler] = None,
                 prefill_chunk: int = 8, device=None, quant: str = "off"):
        if cfg.family not in M.KV_FAMILIES:
            raise ValueError(f"draft model must be an attention-cache "
                             f"family {M.KV_FAMILIES}, not {cfg.family!r}")
        if spec_k < 1:
            raise ValueError(f"spec_k must be >= 1, got {spec_k}")
        if quant not in ("off", "int8"):
            raise ValueError(f"unknown draft quant {quant!r} (the engine's "
                             f"draft_quant); expected 'off' or 'int8'")
        self.cfg = cfg
        self.device = resolve_device(device)
        if quant == "int8":
            # quantize the f32 weights once, before any cast, on the card
            params = M.quantize_params(on_device(params, self.device))
        self.params = place_params(params, self.device,
                                   getattr(torch, cfg.dtype))
        self.spec_k = spec_k
        self.max_slots = max_slots
        self.prefill_chunk = max(1, prefill_chunk)
        self.sampler = sampler or Sampler()
        # lengths past attn_chunk must be chunk multiples
        a = cfg.attn_chunk
        ml = max_len
        if ml > a and ml % a:
            ml += a - ml % a
        self.max_len = ml
        self.cache = M.init_cache(cfg, max_slots, ml, self.device)
        self._sub = M.init_cache(cfg, 1, ml, self.device)
        pin = self.device.type == "cuda"
        self._tokens_h = torch.zeros((max_slots, 1), dtype=torch.int64,
                                     pin_memory=pin)
        self._pos_h = torch.full((max_slots,), -1, dtype=torch.int32,
                                 pin_memory=pin)
        self._step_tokens = torch.zeros_like(self._tokens_h, device=self.device)
        self._step_pos = torch.full_like(self._pos_h, -1, device=self.device)
        self._rem_token = torch.zeros((1, 1), dtype=torch.int64,
                                      device=self.device)
        self._rem_pos = torch.full((1,), -1, dtype=torch.int32,
                                   device=self.device)
        self.draft_time = 0.0          # seconds inside draft rounds
        self.prefill_time = 0.0        # seconds inside draft admission
        self.capture_s = 0.0
        self.graph_pool_bytes = 0
        self._build_steps()

    # -- the steps (as the engine's) ------------------------------------
    def _decode_fn(self):
        logits, _ = M.decode_step(self.cfg, self.params, self._step_tokens,
                                  self._step_pos, self.cache)
        return logits

    def _remainder_fn(self):
        logits, _ = M.decode_step(self.cfg, self.params, self._rem_token,
                                  self._rem_pos, self._sub)
        return logits

    def _build_steps(self) -> None:
        if self.device.type != "cuda":
            self._step, self._remainder_step = \
                self._decode_fn, self._remainder_fn
            return
        t0 = time.perf_counter()
        self._step = CapturedStep(self._decode_fn, self.device,
                                  "the draft's decode step")
        self._remainder_step = CapturedStep(
            self._remainder_fn, self.device,
            "the draft's prefill-remainder step")
        self.capture_s = time.perf_counter() - t0
        self.graph_pool_bytes = (self._step.pool_bytes
                                 + self._remainder_step.pool_bytes)

    # -- admission ------------------------------------------------------
    def admit(self, slot: int, ctx: np.ndarray) -> None:
        """Prefill the slot's context into the draft cache (rows
        0 .. len(ctx) - 1), as the engine's admission prefills: the
        bucket, then one-token remainder steps. Called on every
        (re-)admission; a resumed request's fuller context overwrites the
        stale rows."""
        ctx = np.asarray(ctx, np.int32).reshape(-1)
        L = len(ctx)
        t0 = time.perf_counter()
        lb = L - (L % self.prefill_chunk) or L
        tokens = torch.as_tensor(ctx, dtype=torch.long, device=self.device)
        for leaf in self._sub.values():
            leaf.zero_()
        M.prefill(self.cfg, self.params, {"tokens": tokens[None, :lb]},
                  self._sub)
        for i in range(lb, L):
            self._rem_token.copy_(tokens[None, i:i + 1])
            self._rem_pos.fill_(i)
            self._remainder_step()
        for name, leaf in self._sub.items():
            self.cache[name][:, slot] = leaf[:, 0]
        self.prefill_time += time.perf_counter() - t0

    # -- the draft round ------------------------------------------------
    def draft_round(self, tokens: np.ndarray, pos: np.ndarray,
                    k_vec: np.ndarray):
        """Propose up to k_vec[s] draft tokens a slot.

        tokens: (S, 1) pending token a slot; pos: (S,) its position
        (< 0: idle slot); k_vec: (S,) draft count a slot (a slot near its
        budget proposes fewer than spec_k).

        Runs spec_k + 1 one-token draft steps: step i feeds the last
        token (the pending one for i = 0, else d_i) at pos + i for every
        slot with i <= k_vec[s], and pos = -1 elsewhere. The last feed
        writes d_k's own row, so a fully accepted round leaves the draft
        cache complete up to the bonus token's position.

        Returns (drafts (S, spec_k) int32, qprobs): qprobs is the
        (S, spec_k, vocab) distributions a stochastic draft sampler drew
        from, or None for a greedy one.
        """
        pos = np.asarray(pos, np.int32)
        k_vec = np.asarray(k_vec, np.int32)
        s_n = pos.shape[0]
        k = self.spec_k
        drafts = np.zeros((s_n, k), np.int32)
        qprobs = None
        if self.sampler.config.kind != "greedy":
            qprobs = np.zeros((s_n, k, self.cfg.vocab), np.float64)
        cur = self._tokens_h.numpy()
        cur[:] = np.asarray(tokens).reshape(s_n, 1)
        pos_h = self._pos_h.numpy()
        t0 = time.perf_counter()
        for i in range(k + 1):
            pos_h[:] = np.where((pos >= 0) & (i <= k_vec), pos + i, -1)
            self._step_tokens.copy_(self._tokens_h, non_blocking=True)
            self._step_pos.copy_(self._pos_h, non_blocking=True)
            logits = self._step()
            if i == k:
                break                  # the last feed only writes its row
            rows = logits[:, -1, :self.cfg.vocab].cpu().numpy()  # sync point
            for s in range(s_n):
                if pos[s] >= 0 and i < k_vec[s]:
                    tok = self.sampler(rows[s])
                    drafts[s, i] = tok
                    if qprobs is not None:
                        qprobs[s, i] = self.sampler.probs(rows[s])
                    cur[s, 0] = tok
        self.draft_time += time.perf_counter() - t0
        return drafts, qprobs
