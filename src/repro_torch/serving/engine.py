"""Continuous-batching serving engine over a fixed pool of KV slots.

Request lifecycle (one slot = one batch row of the decode step):

        submit            slot free & arrived          len == max_new
    req ------> WAITING ----------------------> ACTIVE --------------> FINISHED
                          admit = prefill(1xL)    |    evict: pos[slot] = -1,
                          + copy into slot row    |    slot back in free pool
                                                  | a non-finite logits row
                                                  +----------> QUARANTINED

Every decode step runs the model once over ALL slots with a per-slot
position vector `pos: (S,) int32`; idle slots carry pos = -1, so their
cache rows are left alone and their logits are discarded. Each row is
checked before it is sampled, at admission and at every decode step: a
row that is not all finite ends only its own request (QUARANTINED, with
`error` set, counted in the report's "quarantined") and frees its slot
and pages, as the JAX engine does; the other slots' rows never mix with
it, so their streams go on unchanged.

Admission prefills the prompt at batch 1 into the engine's one-slot
sub-cache, zeroed first, over a length bucketed down to a multiple of
`PREFILL_CHUNK`; the remaining tokens run as one-token steps at a (1,)
position vector, and the sub-cache is then copied into the slot's row.

The steps (`_build_steps`), as the JAX engine jits its serve step: the
decode step over all slots (`_step`) and the admission's one-token
remainder step (`_remainder_step`) each read only tensors the engine
owns for its life: the params, the cache (its page table too) or the
sub-cache, and static token and position tensors, which a step fills
with `copy_` from the host state before it runs. On the card each step
is captured once, at construction with every slot idle, in a CUDA graph
(`_CapturedStep`), and a step is a replay: one launch where eager
PyTorch dispatches thousands of ops. On the CPU the engine calls the
same functions directly. A step that cannot be captured (a host sync in
it, for one) raises RuntimeError from the constructor: the card never
runs a step eagerly. The admission prefill stays eager (a graph per
prompt length would cost a memory pool each).

Paged mode (kv_layout="paged"): the per-slot cache rows are replaced by
a fixed pool of KV pages and a per-slot page table
(models.init_paged_cache + serving.kv_pool). Admission still prefills
into a dense batch-1 sub-cache, but copies it out page by page
(`_write_page`), and pages whose content hash matches a resident prompt
page are shared instead of written. Before each decode step
`pool.prepare_write` makes every slot's write page private: a write
into a shared page becomes a copy-on-write (`_copy_page`). Admission
waits while the pool cannot guarantee a request's whole write range.
quant_kv="int8" stores pages as int8 with per-(position, head) scales,
quantized at page write; quant="int8" quantizes the dense weights once,
at construction (the embedding stays in the compute dtype).

Family ssm (Mamba-2): a slot's cache row is its recurrent state (the SSD
state and the conv tails of every layer), which admission copies in
leaf by leaf. The state has no positions, so neither a page pool nor
int8 weights or pages apply, and max_len only bounds what a request may
ask for. A decode step steps every row, an idle slot's on garbage that
its next admission overwrites, as in the JAX engine.

These are the dense, paged and int8 paths of the JAX package's
`ServingEngine`, with the policy fields kv_layout / quant_kv / quant as
constructor arguments. A kernel fault propagates: there is no retry and
no degraded backend; preemption is not ported, so a head that the pool
cannot take waits for pages to free.
"""

from __future__ import annotations

import math
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.core import precision
from repro_torch.core.device import resolve_device
from repro_torch.kernels import ops as kops
from repro_torch.models import model as M
from repro_torch.serving.kv_pool import KVPagePool, KVPoolExhausted
from repro_torch.serving.request import (FINISHED, QUARANTINED, Request,
                                         percentile)
from repro_torch.serving.sampler import greedy
from repro_torch.serving.scheduler import SlotScheduler

# Admission prefill buckets prompt lengths down to a multiple of this
# (remainder tokens run through one-token steps).
PREFILL_CHUNK = 8
# An engine with no slot busy sleeps this long, at least, between polls
# for the next arrival.
IDLE_SLEEP_S = 1e-3
# Tokens per KV page in paged mode: small enough that internal
# fragmentation (half a page a request on average) stays small.
DEFAULT_PAGE_SIZE = 16
KV_LAYOUTS = ("dense", "paged")
QUANT_MODES = ("off", *precision.QUANT_MODES)
# Eager runs of a step on a side stream before its capture: the first
# builds and loads the kernels and sets their attributes, host work that
# a capture must not see.
WARMUP_RUNS = 2


def _place(tree, device, dtype):
    """The params on `device`, float matrix weights ("w" leaves) in the
    compute dtype; norm scales and the int8 weights' leaves ("w_q" int8,
    "w_scale" f32) as they are. The JAX package casts each weight to the
    activation dtype on every call; casting once here gives the same
    values."""
    return {k: _place(v, device, dtype) if isinstance(v, dict)
            else v.to(device, dtype if k == "w" else v.dtype)
            for k, v in tree.items()}


def _on(tree, device):
    return {k: _on(v, device) if isinstance(v, dict) else v.to(device)
            for k, v in tree.items()}


def check_modes(cfg, kv_layout: str, quant_kv: str, quant: str) -> None:
    """Raise ValueError for a cache layout or quantization mode the
    engine does not serve `cfg` with."""
    if kv_layout not in KV_LAYOUTS:
        raise ValueError(f"unknown kv_layout {kv_layout!r}; expected "
                         f"one of {KV_LAYOUTS}")
    for name, mode in (("quant_kv", quant_kv), ("quant", quant)):
        if mode not in QUANT_MODES:
            raise ValueError(f"unknown {name} {mode!r}; expected one "
                             f"of {QUANT_MODES}")
    paged = kv_layout == "paged"
    if cfg.family == "ssm" and (paged or quant_kv != "off" or quant != "off"):
        raise ValueError(
            f"{cfg.name} ({cfg.family}) keeps a recurrent state, not a KV "
            f"cache: kv_layout='paged', quant_kv and quant apply to the "
            f"dense family only")
    if quant_kv != "off" and not paged:
        raise ValueError(
            "quant_kv applies to KV pages; it requires "
            "kv_layout='paged' (dense caches stay full precision)")


class ServingEngine:
    def __init__(self, cfg, params, *, max_slots: int, max_len: int,
                 device=None, kv_layout: str = "dense",
                 quant_kv: str = "off", quant: str = "off",
                 page_size: int = DEFAULT_PAGE_SIZE,
                 kv_pool_pages: Optional[int] = None):
        check_modes(cfg, kv_layout, quant_kv, quant)
        paged = kv_layout == "paged"
        self.cfg = cfg
        self.device = resolve_device(device)
        if quant == "int8":
            # quantize the f32 weights once, before any cast, on the card
            params = M.quantize_params(_on(params, self.device))
        self.params = _place(params, self.device, getattr(torch, cfg.dtype))
        self.max_slots = max_slots
        # chunked_attention needs kv lengths beyond attn_chunk to be
        # chunk multiples; max_len is trace-dependent, so round it up (an
        # ssm state has no length to round). Paged mode also needs a whole
        # number of pages, so the admission page copies never straddle the
        # sub-cache's end.
        a = cfg.attn_chunk
        if paged:
            m = math.lcm(a, page_size) if max_len > a else page_size
            if max_len % m:
                max_len += m - max_len % m
        elif cfg.family != "ssm" and max_len > a and max_len % a:
            max_len += a - max_len % a
        self.max_len = max_len
        self.scheduler = SlotScheduler(max_slots)

        self.page_size = page_size if paged else None
        self.pool: Optional[KVPagePool] = None
        if paged:
            pages_per_slot = max_len // page_size
            # default pool: the dense layout's token capacity; prefix
            # sharing and short requests turn unused rows into headroom
            n_pages = (max_slots * pages_per_slot if kv_pool_pages is None
                       else kv_pool_pages)
            self.pool = KVPagePool(n_pages, page_size, max_slots,
                                   pages_per_slot)
            self.cache = M.init_paged_cache(
                cfg, n_pages, page_size, max_slots, pages_per_slot,
                quant_kv=quant_kv, device=self.device)
            self._table_version = self.pool.version
        else:
            self.cache = M.init_cache(cfg, max_slots, max_len, self.device)

        # per-slot host state (pos < 0 = idle slot), pinned on the card;
        # a step copies it into its static device tensors
        pin = self.device.type == "cuda"
        self._tokens_h = torch.zeros((max_slots, 1), dtype=torch.int64,
                                     pin_memory=pin)
        self._pos_h = torch.full((max_slots,), -1, dtype=torch.int32,
                                 pin_memory=pin)
        self._tokens, self._pos = self._tokens_h.numpy(), self._pos_h.numpy()
        self._step_tokens = torch.zeros_like(self._tokens_h, device=self.device)
        self._step_pos = torch.full_like(self._pos_h, -1, device=self.device)
        # the admission's sub-cache and the remainder step's inputs
        self._sub = M.init_cache(cfg, 1, max_len, self.device)
        self._rem_token = torch.zeros((1, 1), dtype=torch.int64,
                                      device=self.device)
        self._rem_pos = torch.full((1,), -1, dtype=torch.int32,
                                   device=self.device)

        self.requests: List[Request] = []
        self._next_rid = 0
        self._t0: Optional[float] = None
        self.prefill_tokens = 0
        self.prefill_time = 0.0
        self.decode_steps = 0
        self.decode_time = 0.0
        self.decode_slot_steps = 0     # sum of active slots over steps
        self.tokens_emitted = 0
        self.quarantined = 0
        self.peak_occupancy = 0
        self._step_times: List[float] = []
        self.capture_s = 0.0           # _build_steps' warm-ups and captures
        self.graph_pool_bytes = 0      # the graphs' private memory pools
        self._build_steps()

    # -- the steps -----------------------------------------------------
    def _decode_fn(self):
        """One token for every slot from the static inputs, into the
        cache in place; (S, 1, padded_vocab) f32 logits."""
        logits, _ = M.decode_step(self.cfg, self.params, self._step_tokens,
                                  self._step_pos, self.cache)
        return logits

    def _remainder_fn(self):
        """One prompt token at batch 1 into the sub-cache, at the (1,)
        position vector (the per-slot path of a decode step)."""
        logits, _ = M.decode_step(self.cfg, self.params, self._rem_token,
                                  self._rem_pos, self._sub)
        return logits

    def _build_steps(self) -> None:
        """Make `_step` and `_remainder_step`: on the card, CUDA graphs of
        `_decode_fn` and `_remainder_fn`, captured while every slot is
        idle (pos = -1, so the warm-ups and captures write no KV row; an
        ssm state steps only idle rows, which admission overwrites); on
        the CPU, the functions themselves."""
        if self.device.type != "cuda":
            self._step, self._remainder_step = \
                self._decode_fn, self._remainder_fn
            return
        t0 = time.perf_counter()
        self._step = _CapturedStep(self._decode_fn, self.device,
                                   "the decode step")
        self._remainder_step = _CapturedStep(self._remainder_fn, self.device,
                                             "the prefill-remainder step")
        self.capture_s = time.perf_counter() - t0
        self.graph_pool_bytes = (self._step.pool_bytes
                                 + self._remainder_step.pool_bytes)

    # -- submission ----------------------------------------------------
    def submit(self, prompt, max_new_tokens: int, *,
               arrival_time: float = 0.0) -> Request:
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size + max_new_tokens > self.max_len:
            raise ValueError(
                f"request (prompt {prompt.size} + gen {max_new_tokens}) "
                f"exceeds the engine's max_len {self.max_len}")
        if self.pool is not None:
            # refused here when not even an empty pool could take it, so
            # it cannot wedge the FCFS queue; a full pool only defers.
            # Admission takes the prompt's pages plus a reservation for
            # every page of the write range, the partial tail page
            # included (it may be copied on write), so count both.
            ps, n = self.page_size, prompt.size
            need = -(-n // ps) + (n + max_new_tokens - 1) // ps - n // ps + 1
            if need > self.pool.n_pages:
                raise KVPoolExhausted(
                    f"request needs {need} KV pages (prompt {n} + gen "
                    f"{max_new_tokens} @ page_size {ps}, the write range "
                    f"reserved) but the pool only has {self.pool.n_pages}")
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

    # -- page pool copies (paged layout) -------------------------------
    def _write_page(self, sub, phys: int, start: int) -> None:
        """Copy `page_size` prefilled rows from `start` of the dense batch-1
        sub-cache into pool page `phys` of every layer, quantized on an
        int8 pool."""
        pages = self.cache["pages"]
        ps = self.page_size
        for name in ("k", "v"):
            rows = sub[name][:, 0, start:start + ps]      # (L, ps, Hkv, Dh)
            if "ks" in pages:
                q, s = precision.quantize_kv(rows)        # s: (L, ps, Hkv)
                pages[name][:, phys] = q
                pages[name + "s"][:, phys] = s.transpose(1, 2)
            else:
                pages[name][:, phys] = rows.to(pages[name].dtype)

    def _copy_page(self, src: int, dst: int) -> None:
        """Page src -> dst in every layer's pool (copy-on-write)."""
        for leaf in self.cache["pages"].values():
            leaf[:, dst] = leaf[:, src]

    def _sync_table(self) -> None:
        """Mirror the host page table into the cache's table tensor, in
        place (the captured step reads that tensor), when the pool has
        changed it since the last step."""
        if self.pool.version != self._table_version:
            self.cache["table"].copy_(torch.from_numpy(self.pool.table))
            self._table_version = self.pool.version

    def _copy_prefill(self, slot: int, sub, plan) -> None:
        """Dense: the slot's row of every leaf (K and V, or an ssm
        state's leaves). Paged: each freshly allocated prompt page; pages
        shared with a resident prefix are never rewritten."""
        if self.pool is None:
            for name, leaf in sub.items():
                self.cache[name][:, slot] = leaf[:, 0]
            return
        for j, phys in plan.private:
            self._write_page(sub, phys, j * self.page_size)

    # -- admission (prefill path) ---------------------------------------
    def _admit(self, req: Request) -> None:
        slot = self.scheduler.admit(req)
        ctx = req.prompt
        plan = None
        if self.pool is not None:
            plan = self.pool.admit_slot(slot, ctx, req.max_new_tokens)
        req.t_admitted = self._now()
        t0 = time.perf_counter()

        L = len(ctx)
        lb = L - (L % PREFILL_CHUNK) or L   # bucket down; short prompts exact
        tokens = torch.as_tensor(ctx, dtype=torch.long, device=self.device)
        sub = self._sub
        for leaf in sub.values():
            leaf.zero_()
        logits, _ = M.prefill(self.cfg, self.params,
                              {"tokens": tokens[None, :lb]}, sub)
        for i in range(lb, L):         # remainder: one-token steps
            self._rem_token.copy_(tokens[None, i:i + 1])
            self._rem_pos.fill_(i)
            logits = self._remainder_step()
        self._copy_prefill(slot, sub, plan)

        row = logits[0, -1, :self.cfg.vocab].cpu().numpy()   # sync point
        self.prefill_time += time.perf_counter() - t0
        self.prefill_tokens += L
        now = self._now()
        if not np.isfinite(row).all():
            self._quarantine(req, slot, now,
                             "non-finite logits at admission prefill")
            return
        tok = greedy(row)
        req.t_first_token = now
        req.generated.append(tok)
        self.tokens_emitted += 1
        if req.n_generated >= req.max_new_tokens:
            self._release(req, slot, now)
        else:
            self._pos[slot] = L
            self._tokens[slot, 0] = tok

    def _release(self, req: Request, slot: int, now: float,
                 status: str = FINISHED) -> None:
        """Free the slot and its KV pages (shared pages drop one
        reference; their other holders keep the bytes)."""
        self.scheduler.release(slot, status)
        if self.pool is not None:
            self.pool.release_slot(slot)
        self._pos[slot] = -1
        self._tokens[slot, 0] = 0
        req.t_finished = now

    def _quarantine(self, req: Request, slot: int, now: float,
                    error: str) -> None:
        """End only this request, on a logits row that is not finite."""
        req.error = error
        self.quarantined += 1
        self._release(req, slot, now, QUARANTINED)

    # -- decode --------------------------------------------------------
    def _prepare_pages(self, active) -> None:
        """Make each active slot's write position private before the step
        writes it: a shared page is copied (CoW), a page past the mapped
        prefix comes from the admission's reservation; then sync the
        table. Eager, on the stream the step replays on."""
        for slot in active:
            w = self.pool.prepare_write(slot, int(self._pos[slot]))
            if w is not None and w.kind == "cow":
                self._copy_page(w.src, w.dst)
        self._sync_table()

    def _decode_once(self) -> None:
        active = self.scheduler.active
        if not active:
            raise ValueError("decode step with no active slots")
        step_idx = self.decode_steps
        if self.pool is not None:
            self._prepare_pages(active)
        t0 = time.perf_counter()
        self._step_tokens.copy_(self._tokens_h, non_blocking=True)
        self._step_pos.copy_(self._pos_h, non_blocking=True)
        logits = self._step()
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
            if not np.isfinite(rows[slot]).all():
                self._quarantine(req, slot, now, f"non-finite logits at "
                                 f"decode step {step_idx}")
                continue
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
        """Admit every ready request the pool can take (FCFS: a head that
        does not fit waits), then run one decode step if any slot is
        active. Returns False when all work is drained."""
        while True:
            req = self.scheduler.next_admission(self._now())
            if req is None:
                break
            if self.pool is not None and not self.pool.can_admit(
                    req.prompt, req.max_new_tokens):
                break               # the head waits for pages to free
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
        out = {
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
            "quarantined": self.quarantined,
            "decode_step_p50_s": percentile(self._step_times, 50),
            "decode_step_p99_s": percentile(self._step_times, 99),
        }
        if self.pool is not None:
            out["kv_pool"] = self.pool.report()
        return out


class _CapturedStep:
    """`fn()` captured in a CUDA graph on `device`, the counterpart of a
    jitted step. `fn` reads and writes only tensors that outlive the
    graph (the params, a cache, static inputs). Calling this replays on
    the current stream the kernels `fn` launched, against the same
    tensors, and returns the tensor `fn` returned, which the replay
    rewrites. A replay calls no kernel wrapper, so it adds the launches
    that the capture counted to `ops.launch_counts()`; the counts of the
    warm-up runs and of the capture itself are taken out. Raises
    RuntimeError when `fn` cannot be captured: nothing falls back to
    running it eagerly."""

    def __init__(self, fn, device, what: str):
        start = kops.launch_counts()
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        try:
            with torch.cuda.stream(side):
                for _ in range(WARMUP_RUNS):
                    fn()
            torch.cuda.synchronize(device)
            torch.cuda.empty_cache()
            reserved = torch.cuda.memory_reserved(device)
            warm = kops.launch_counts()
            self.graph = torch.cuda.CUDAGraph()
            try:
                with torch.cuda.stream(side):
                    self.graph.capture_begin()
                    try:
                        self.out = fn()
                    except BaseException:
                        _end_broken_capture(self.graph)
                        raise
                    self.graph.capture_end()
            except RuntimeError as e:
                raise RuntimeError(
                    f"capturing {what} in a CUDA graph failed: the step "
                    f"must launch its work on the current stream with no "
                    f"host sync (.item(), .cpu(), a shape that depends on "
                    f"the data, torch.cuda.synchronize); the cause is "
                    f"above") from e
        finally:
            done = kops.launch_counts()
            kops.add_launch_counts({k: start[k] - n for k, n in done.items()})
        self.launches = {k: done[k] - warm[k] for k in done
                         if done[k] != warm[k]}
        self.pool_bytes = torch.cuda.memory_reserved(device) - reserved

    def __call__(self) -> torch.Tensor:
        self.graph.replay()
        kops.add_launch_counts(self.launches)
        return self.out


def _end_broken_capture(graph) -> None:
    """End a capture that an error in the captured code broke. The caller
    raises that error on; capture_end's own, that the capture is invalid,
    says nothing more, so it is dropped."""
    try:
        graph.capture_end()
    except RuntimeError:
        pass
