"""Continuous-batching serving engine over a fixed pool of dense KV slots.

Request lifecycle (one slot = one batch row of the decode step):

        submit            slot free & arrived          len == max_new
    req ------> WAITING ----------------------> ACTIVE --------------> FINISHED
                          admit = prefill(1xL)         evict: pos[slot] = -1,
                          + copy into slot row         slot back in free pool

Every decode step runs the model once over ALL slots with a per-slot
position vector `pos: (S,) int32`; idle slots carry pos = -1, so their
cache rows are left alone and their logits are discarded.

Admission prefills the prompt at batch 1 into a fresh one-slot cache,
over a length bucketed down to a multiple of `PREFILL_CHUNK`; the
remaining tokens run as one-token steps at a scalar position, and the
sub-cache is then copied into the slot's row.

This is the dense-KV path of the JAX package's `ServingEngine`. A
kernel fault propagates: there is no retry and no degraded backend.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.core.device import resolve_device
from repro_torch.models import model as M
from repro_torch.serving.request import FINISHED, Request, percentile
from repro_torch.serving.sampler import greedy
from repro_torch.serving.scheduler import SlotScheduler

# Admission prefill buckets prompt lengths down to a multiple of this
# (remainder tokens run through one-token steps).
PREFILL_CHUNK = 8
# An engine with no slot busy sleeps this long, at least, between polls
# for the next arrival.
IDLE_SLEEP_S = 1e-3


def _place(tree, device, dtype):
    """The params on `device`, matrix weights ("w" leaves) in the compute
    dtype and norm scales as they are. The JAX package casts each weight
    to the activation dtype on every call; casting once here gives the
    same values."""
    return {k: _place(v, device, dtype) if isinstance(v, dict)
            else v.to(device, dtype if k == "w" else v.dtype)
            for k, v in tree.items()}


class ServingEngine:
    def __init__(self, cfg, params, *, max_slots: int, max_len: int,
                 device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.params = _place(params, self.device, getattr(torch, cfg.dtype))
        self.max_slots = max_slots
        # chunked_attention needs kv lengths beyond attn_chunk to be
        # chunk multiples; max_len is trace-dependent, so round it up.
        a = cfg.attn_chunk
        if max_len > a and max_len % a:
            max_len += a - max_len % a
        self.max_len = max_len
        self.scheduler = SlotScheduler(max_slots)
        self.cache = M.init_cache(cfg, max_slots, max_len, self.device)

        # per-slot host state (pos < 0 = idle slot)
        self._tokens = np.zeros((max_slots, 1), np.int64)
        self._pos = np.full((max_slots,), -1, np.int32)

        self.requests: List[Request] = []
        self._next_rid = 0
        self._t0: Optional[float] = None
        self.prefill_tokens = 0
        self.prefill_time = 0.0
        self.decode_steps = 0
        self.decode_time = 0.0
        self.decode_slot_steps = 0     # sum of active slots over steps
        self.tokens_emitted = 0
        self.peak_occupancy = 0
        self._step_times: List[float] = []

    # -- submission ----------------------------------------------------
    def submit(self, prompt, max_new_tokens: int, *,
               arrival_time: float = 0.0) -> Request:
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size + max_new_tokens > self.max_len:
            raise ValueError(
                f"request (prompt {prompt.size} + gen {max_new_tokens}) "
                f"exceeds the engine's max_len {self.max_len}")
        req = Request(rid=self._next_rid, prompt=prompt,
                      max_new_tokens=max_new_tokens, arrival_time=arrival_time)
        self._next_rid += 1
        self.requests.append(req)
        self.scheduler.submit(req)
        return req

    def _now(self) -> float:
        if self._t0 is None:
            self._t0 = time.perf_counter()
        return time.perf_counter() - self._t0

    # -- admission (prefill path) ---------------------------------------
    def _admit(self, req: Request) -> None:
        slot = self.scheduler.admit(req)
        ctx = req.prompt
        req.t_admitted = self._now()
        t0 = time.perf_counter()

        L = len(ctx)
        lb = L - (L % PREFILL_CHUNK) or L   # bucket down; short prompts exact
        tokens = torch.as_tensor(ctx, dtype=torch.long, device=self.device)
        sub = M.init_cache(self.cfg, 1, self.max_len, self.device)
        logits, sub = M.prefill(self.cfg, self.params,
                                {"tokens": tokens[None, :lb]}, sub)
        for i in range(lb, L):         # remainder: one-token steps
            logits, sub = M.decode_step(self.cfg, self.params,
                                        tokens[None, i:i + 1], i, sub)
        for name in ("k", "v"):
            self.cache[name][:, slot] = sub[name][:, 0]

        row = logits[0, -1, :self.cfg.vocab].cpu().numpy()   # sync point
        self.prefill_time += time.perf_counter() - t0
        self.prefill_tokens += L
        now = self._now()
        tok = greedy(row)
        req.t_first_token = now
        req.generated.append(tok)
        self.tokens_emitted += 1
        if req.n_generated >= req.max_new_tokens:
            self._release(req, slot, now)
        else:
            self._pos[slot] = L
            self._tokens[slot, 0] = tok

    def _release(self, req: Request, slot: int, now: float) -> None:
        self.scheduler.release(slot, FINISHED)
        self._pos[slot] = -1
        self._tokens[slot, 0] = 0
        req.t_finished = now

    # -- decode --------------------------------------------------------
    def _decode_once(self) -> None:
        active = self.scheduler.active
        if not active:
            raise ValueError("decode step with no active slots")
        t0 = time.perf_counter()
        tokens = torch.as_tensor(self._tokens, device=self.device)
        pos = torch.as_tensor(self._pos, device=self.device)
        logits, self.cache = M.decode_step(self.cfg, self.params, tokens,
                                           pos, self.cache)
        rows = logits[:, -1, :self.cfg.vocab].cpu().numpy()  # sync point
        dt = time.perf_counter() - t0
        self.decode_time += dt
        self._step_times.append(dt)
        self.decode_steps += 1
        self.decode_slot_steps += len(active)
        self.peak_occupancy = max(self.peak_occupancy, len(active))
        now = self._now()
        for slot in sorted(active):
            req = active[slot]
            tok = greedy(rows[slot])
            req.generated.append(tok)
            self.tokens_emitted += 1
            if req.n_generated >= req.max_new_tokens:
                self._release(req, slot, now)
            else:
                self._pos[slot] += 1
                self._tokens[slot, 0] = tok

    # -- driving -------------------------------------------------------
    def step(self) -> bool:
        """Admit every ready request, then run one decode step if any slot
        is active. Returns False when all work is drained."""
        while True:
            req = self.scheduler.next_admission(self._now())
            if req is None:
                break
            self._admit(req)
        if self.scheduler.n_active:
            self._decode_once()
        return self.scheduler.has_work()

    def run(self) -> Dict[str, Any]:
        """Drive to completion; returns the stats report."""
        while self.scheduler.has_work():
            if not self.step():
                break
            if not self.scheduler.n_active:
                nxt = self.scheduler.next_arrival_time()
                if nxt is not None:
                    time.sleep(max(IDLE_SLEEP_S, min(nxt - self._now(), 0.05)))
        return self.report()

    # -- stats ----------------------------------------------------------
    def report(self) -> Dict[str, Any]:
        done = [r for r in self.requests if r.status == FINISHED]
        lat = [r.latency for r in done]
        ttft = [r.ttft for r in done]
        decode_tokens = self.tokens_emitted - len(
            [r for r in self.requests if r.t_first_token is not None])
        return {
            "n_requests": len(self.requests),
            "n_finished": len(done),
            "prefill_tokens": self.prefill_tokens,
            "prefill_tok_s": self.prefill_tokens / max(self.prefill_time, 1e-9),
            "decode_tokens": decode_tokens,
            "decode_steps": self.decode_steps,
            "decode_tok_s": (self.decode_slot_steps
                             / max(self.decode_time, 1e-9)),
            "mean_occupancy": (self.decode_slot_steps
                               / max(self.decode_steps, 1)),
            "latency_p50_s": percentile(lat, 50),
            "latency_p95_s": percentile(lat, 95),
            "ttft_p50_s": percentile(ttft, 50),
            "ttft_p95_s": percentile(ttft, 95),
            "peak_occupancy": self.peak_occupancy,
            "decode_step_p50_s": percentile(self._step_times, 50),
            "decode_step_p99_s": percentile(self._step_times, 99),
        }
