"""Continuous-batching serving engine over a fixed pool of KV slots.

Request lifecycle (one slot = one batch row of the decode step):

        submit          slot free & eligible        max_new tokens or eos
    req ------> WAITING -------------------> ACTIVE ---------------------> FINISHED
                 |   ^    admit = prefill(1xL)  |  |
                 |   |    + copy into slot row  |  +-- cancel(rid) ------> CANCELLED
                 |   +---- preempted (paged) ---+  +-- non-finite row ---> QUARANTINED
                 +-- deadline passed -----------------------------------> EXPIRED
                 +-- cancel(rid) ---------------------------------------> CANCELLED

Every decode step runs the model once over ALL slots with a per-slot
position vector `pos: (S,) int32`; idle slots carry pos = -1, so their
cache rows are left alone and their logits are discarded. Each row is
checked before it is sampled, at admission and at every step: a row that
is not all finite ends only its own request (QUARANTINED, with `error`
set), as the JAX engine does; the other slots' rows never mix with it.
Tokens are chosen on the host by a `sampler.Sampler` (greedy by
default; temperature and top-k); a request ends at `max_new_tokens` or
at `eos_id`.

Admission prefills the prompt at batch 1 into the engine's one-slot
sub-cache, zeroed first, over a length bucketed down to a multiple of
`prefill_chunk`; the remaining tokens run as one-token steps at a (1,)
position vector, and the sub-cache is then copied into the slot's row.

Deadlines, cancel and preemption, as the JAX engine has them: each step
first drops the waiters whose deadline has passed (EXPIRED; a request
already admitted is never dropped). `cancel(rid)` ends a waiting or an
active request at once and frees its slot and pages. In paged mode a
FCFS head that the pool cannot take preempts the lowest-priority, then
youngest, active request that it strictly outranks and that has retries
left (`preempt_retry_budget`): its pages go back to the pool, and it
waits again at its rid's place, eligible after a backoff that doubles
with each preemption (`preempt_backoff`). Equal priorities never
preempt; the head waits. A resumed request recomputes its context
(recompute-on-resume) by the route of its first admission, the prompt's
bucket prefilled and the rest run through the remainder step, its
generated tokens included, so every row it writes has the bits the
uninterrupted run wrote (the JAX engine prefills the whole context).

Speculative decoding (`draft=(cfg, params)`): each step is a round. The
draft (`serving.spec.SpecDecoder`) proposes up to `spec_k` tokens a
slot; the target's verify step (`models.model.verify_step`) scores the
pending token and the proposals of every slot in one forward, whose
attention is the decode kernel's multi-row form, so each of its rows
and the cache rows it writes are a decode step's bits; the sampler's
leftover/residual rule (`speculative_accept`) emits 1 .. k + 1 tokens a
slot, and the eos token truncates a round. Rollback is positional (see
serving.spec). In paged mode every page a round may write is made
private (copy-on-write) before the verify step runs.

The steps (`_build_steps`), as the JAX engine jits its serve step: the
decode step over all slots (`_step`), the admission's one-token
remainder step (`_remainder_step`) and, with a draft, the verify step
over static (S, k + 1) tokens (`_verify_step`) each read only tensors
the engine owns for its life: the params, the cache (its page table
too) or the sub-cache, and static token, position and count tensors,
which a step fills with `copy_` from the host state before it runs. On
the card each step is captured once, at construction with every slot
idle, in a CUDA graph (`steps.CapturedStep`), as are the draft's, and a
step is a replay. On the CPU the engine calls the same functions
directly. A step that cannot be captured (a host sync in it, for one)
raises RuntimeError from the constructor: the card never runs a step
eagerly. The admission prefill stays eager.

Paged mode (kv_layout="paged"): the per-slot cache rows are replaced by
a fixed pool of KV pages and a per-slot page table
(models.init_paged_cache + serving.kv_pool). Admission still prefills
into a dense batch-1 sub-cache, but copies it out page by page
(`_write_page`), and pages whose content hash matches a resident prompt
page are shared instead of written. Before each step `pool.prepare_write`
makes every page a slot may write private: a write into a shared page
becomes a copy-on-write (`_copy_page`). Admission waits while the pool
cannot guarantee a request's whole write range. quant_kv="int8" stores
pages as int8 with per-(position, head) scales, quantized at page write.

quant="int8" quantizes the dense weights once, at construction (the
embedding stays in the compute dtype), for every family, as the JAX
engine does: `models.model.quantize_params` says which weights.

Family ssm (Mamba-2): a slot's cache row is its recurrent state (the SSD
state and the conv tails of every layer), which admission copies in
leaf by leaf. The state has no positions, so neither a page pool, int8
pages nor a verify step apply, and max_len only bounds what a request
may ask for. A decode step steps every row, an idle slot's on garbage
that its next admission overwrites, as in the JAX engine. Family hybrid
(Zamba2): that state for every Mamba layer, and the shared attention
block's KV cache of every segment, written at pos as the dense family's
(max_len rounds as theirs); neither a page pool, int8 pages nor a
verify step apply either. A leaf's slot axis is where the engine's cache
and the one-slot sub-cache differ (axis 2 of a hybrid's Mamba leaves,
axis 1 of the rest), and admission copies each leaf along its own.
Family moe (Mixtral, Arctic) takes the dense family's paths, the page
pools, int8 weights (its f32 router and expert banks stay unquantized,
as in the JAX engine) and speculation included. At 4 slots or fewer a
decode step routes at most 4 tokens to an expert, within its capacity
of at least 4, so no decode token is dropped and a stream is its
request alone. A verify step routes its S x (k + 1) rows as one group,
idle slots' and rows past n_tok's tokens too, so capacity can bind
(4 slots at k = 4: 6 slots an expert for 20 rows at mixtral's top-2 of
8); the engine counts the dropped assignments of real rows
(`verify_dropped`, `Request.verify_dropped`). Where a request's real rows
drop nothing, its greedy spec stream is the plain engine's; where they
do, its tokens follow the greedy rule on the verify step's logits. Family vlm
(Qwen2-VL's text decoder) takes every path of the dense family: a text
request's prompt is prefilled at plain positions and
each later token turned by t = h = w = pos (models.model), which is
plain RoPE, as in the JAX engine; neither engine takes patch
embeddings in a request. Family encdec (Whisper): a request carries its
encoder frames (`submit(..., enc_frames=)`, (enc_ctx, d_model)); its
admission prefill runs the encoder and writes each decoder layer's
cross K/V into the sub-cache's "cross" leaves, which the admission
copies into the slot's rows beside the self-attention rows; the decode
and remainder steps read the cross cache in place (a static tensor the
graphs capture), each slot through the decode kernel at its last
encoder key. The cross cache stays enc_ctx long whatever max_len; a page
pool, int8 pages and speculation (as target or draft) are refused, as
the JAX engine refuses them.

Faults, as the JAX engine handles them. A decode step that raises
RuntimeError (a kernel fault, or the chaos injector's
`SimulatedKernelFault`) is retried, up to `max_step_retries` times; past
them it counts as a crashed step and re-raises. Once the kernel faults
reach `kernel_fault_threshold`, the engine rebuilds its captured steps
on the same kernels (`_rebuild_steps`: the old decode and remainder
graphs and their pools freed, both captured again, `degraded` set, one
RuntimeWarning a process), where the JAX engine falls back to plain
XLA: on the card the plain versions are not a fallback the port takes,
and no step runs eagerly after a fault. The rebuild happens with slots
busy: its warm-ups and captures run at every position -1, so no KV row
is written, and a Mamba state, which a step moves at any position, is
saved before and copied back after, so the streams go on as if no fault
had come. On the CPU the rebuild binds the functions again. The chaos
injector (`serving.faults.FaultInjector`, `fault_injector=`) drives
these paths at scripted steps: a NaN logits row after the step, a
private cache page (or a dense slot's rows) poisoned in place before
it, a fault or a sleep before it, a denied admission (the pool taken as
exhausted: preempt or defer). A `StragglerDetector` observes every
decode step and round. Speculative decoding takes no injector, as in
the JAX engine, and its round is not retried.

`draft_quant="int8"` quantizes the draft's weights once (its KV stays
dense), the JAX engine's `draft_policy` with quant="int8".

These are the JAX package's `ServingEngine` paths, with the policy
fields kv_layout / quant_kv / quant (and the draft's quant) as
constructor arguments.
"""

from __future__ import annotations

import math
import time
import warnings
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.core import precision
from repro_torch.core.device import resolve_device
from repro_torch.core.tree import leaves
from repro_torch.distributed.fault_tolerance import StragglerDetector
from repro_torch.models import model as M
from repro_torch.serving.faults import FaultInjector
from repro_torch.serving.kv_pool import KVPagePool, KVPoolExhausted
from repro_torch.serving.request import (ACTIVE, CANCELLED, FINISHED,
                                         QUARANTINED, TERMINAL, WAITING,
                                         Request, percentile)
from repro_torch.serving.sampler import Sampler
from repro_torch.serving.scheduler import SlotScheduler
from repro_torch.serving.spec import SpecDecoder
from repro_torch.serving.steps import CapturedStep, on_device, place_params
from repro_torch.tuning import cache as _tcache

# Admission prefill buckets prompt lengths down to a multiple of this
# (remainder tokens run through one-token steps).
DEFAULT_PREFILL_CHUNK = 8
# An engine with no slot busy sleeps this long, at least, between polls
# for the next arrival.
IDLE_SLEEP_S = 1e-3
# Tokens per KV page in paged mode: small enough that internal
# fragmentation (half a page a request on average) stays small.
DEFAULT_PAGE_SIZE = 16
KV_LAYOUTS = ("dense", "paged")
QUANT_MODES = ("off", *precision.QUANT_MODES)
# Rebuilding the captured steps after repeated kernel faults warns once
# a process.
_REBUILD_WARNED = False


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
    if cfg.family not in M.KV_FAMILIES and (paged or quant_kv != "off"):
        raise ValueError(
            f"{cfg.name} ({cfg.family}) {M._NOT_KV[cfg.family]}: "
            f"kv_layout='paged' and quant_kv apply to the families "
            f"{M.KV_FAMILIES} only")
    if quant_kv != "off" and not paged:
        raise ValueError(
            "quant_kv applies to KV pages; it requires "
            "kv_layout='paged' (dense caches stay full precision)")


def _slot_axis(big, one):
    """The axis along which a cache leaf indexes slots: where the
    engine's max_slots cache differs from the one-slot sub-cache. None:
    no axis differs (max_slots 1), and the whole leaf is the slot's."""
    diffs = [i for i, (a, b) in enumerate(zip(big, one)) if a != b]
    if len(diffs) > 1:
        raise ValueError(f"a cache leaf of shape {tuple(big)} differs from "
                         f"its one-slot shape {tuple(one)} on axes {diffs}; "
                         f"a slot's copy needs one")
    return diffs[0] if diffs else None


class ServingEngine:
    def __init__(self, cfg, params, *, max_slots: int, max_len: int,
                 device=None, kv_layout: str = "dense",
                 quant_kv: str = "off", quant: str = "off",
                 page_size: int = DEFAULT_PAGE_SIZE,
                 kv_pool_pages: Optional[int] = None,
                 sampler: Optional[Sampler] = None,
                 prefill_chunk: int = DEFAULT_PREFILL_CHUNK,
                 eos_id: Optional[int] = None,
                 fault_injector: Optional[FaultInjector] = None,
                 preempt_retry_budget: int = 2,
                 preempt_backoff: float = 0.02,
                 kernel_fault_threshold: int = 2,
                 max_step_retries: int = 2,
                 draft=None, spec_k: int = 4, draft_quant: str = "off",
                 draft_sampler: Optional[Sampler] = None):
        check_modes(cfg, kv_layout, quant_kv, quant)
        paged = kv_layout == "paged"
        self.cfg = cfg
        self.device = resolve_device(device)
        if quant == "int8":
            # quantize the f32 weights once, before any cast, on the card
            params = M.quantize_params(on_device(params, self.device))
        self.params = place_params(params, self.device,
                                   getattr(torch, cfg.dtype))
        self.max_slots = max_slots
        # chunked_attention needs kv lengths beyond attn_chunk to be
        # chunk multiples; max_len is trace-dependent, so round it up (an
        # ssm state has no length to round; an encdec cross cache keeps
        # init_cache's enc_ctx whatever max_len). Paged mode also needs a
        # whole number of pages, so the admission page copies never
        # straddle the sub-cache's end.
        a = cfg.attn_chunk
        if paged:
            m = math.lcm(a, page_size) if max_len > a else page_size
            if max_len % m:
                max_len += m - max_len % m
        elif cfg.family != "ssm" and max_len > a and max_len % a:
            max_len += a - max_len % a
        self.max_len = max_len
        self.prefill_chunk = max(1, prefill_chunk)
        self.eos_id = eos_id
        self.sampler = sampler or Sampler()
        self.scheduler = SlotScheduler(max_slots)
        self.injector = fault_injector
        self.preempt_retry_budget = preempt_retry_budget
        self.preempt_backoff = preempt_backoff
        self.kernel_fault_threshold = kernel_fault_threshold
        self.max_step_retries = max_step_retries
        self.straggler = StragglerDetector()

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
        # the admission's sub-cache, each dense cache leaf's slot axis, and
        # the remainder step's inputs
        self._sub = M.init_cache(cfg, 1, max_len, self.device)
        self._slot_axes = None if paged else [
            _slot_axis(big.shape, one.shape)
            for big, one in zip(leaves(self.cache), leaves(self._sub))]
        self._rem_token = torch.zeros((1, 1), dtype=torch.int64,
                                      device=self.device)
        self._rem_pos = torch.full((1,), -1, dtype=torch.int32,
                                   device=self.device)

        # speculative decoding: the draft, and the verify step's (S, k+1)
        # tokens and (S,) real-token counts (its positions are _step_pos)
        self.spec: Optional[SpecDecoder] = None
        self.spec_k = spec_k
        self.spec_rounds = 0
        self.spec_proposed = 0
        self.spec_accepted = 0
        # moe: the expert assignments of real verify rows dropped, the
        # real rows, and the rounds that dropped any assignment
        self.verify_dropped = 0
        self.verify_rows = 0
        self.verify_rounds_dropping = 0
        if draft is not None:
            if "encdec" in (cfg.family, draft[0].family):
                raise ValueError(
                    f"speculative decoding takes no encdec model, as "
                    f"target or draft ({cfg.name} drafted by "
                    f"{draft[0].name}): the verify and draft steps carry "
                    f"no per-request encoder cache")
            if cfg.family not in M.KV_FAMILIES:
                raise ValueError(
                    f"speculative decoding needs a verify-capable target "
                    f"{M.KV_FAMILIES}, not {cfg.family!r}")
            if fault_injector is not None:
                raise ValueError(
                    "speculative decoding and the chaos injector are "
                    "mutually exclusive: the injector's step hooks assume "
                    "one token per slot per step")
            draft_cfg, draft_params = draft
            if draft_cfg.vocab != cfg.vocab:
                raise ValueError(
                    f"draft vocab {draft_cfg.vocab} != target vocab "
                    f"{cfg.vocab}: acceptance compares distributions "
                    f"over the same token space")
            self.spec = SpecDecoder(
                draft_cfg, draft_params, max_slots=max_slots,
                max_len=self.max_len, spec_k=spec_k, sampler=draft_sampler,
                prefill_chunk=self.prefill_chunk, device=self.device,
                quant=draft_quant)
            self._vtokens_h = torch.zeros((max_slots, spec_k + 1),
                                          dtype=torch.int64, pin_memory=pin)
            self._ntok_h = torch.zeros((max_slots,), dtype=torch.int32,
                                       pin_memory=pin)
            self._v_tokens = torch.zeros_like(self._vtokens_h,
                                              device=self.device)
            self._v_ntok = torch.zeros_like(self._ntok_h, device=self.device)
            # a moe verify step's dropped assignments a row (zeros else)
            self._v_drops = torch.zeros((max_slots, spec_k + 1),
                                        dtype=torch.int32, device=self.device)

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
        self.expired = 0
        self.cancelled = 0
        self.preempted = 0             # preemption events (a request may repeat)
        self.quarantined = 0
        self.kernel_faults = 0
        self.crashed_steps = 0         # steps that ran out of retries
        self.degraded = False          # the steps were rebuilt after faults
        self._admissions = 0           # admissions so far (the ordinal)
        self.capture_s = 0.0           # every graph's warm-ups and capture
        self.graph_pool_bytes = 0      # the graphs' private memory pools
        self.rebuild_s = 0.0           # the rebuild's seconds
        # the tuning cache whose GEMM winners everything the engine runs
        # takes (None: the static plans): the graphs, captured and
        # rebuilt, and each step's eager admission prefills
        self.tuned_cache = _tcache.tuned_cache()
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

    def _verify_fn(self):
        """The pending token and the draft's proposals of every slot, at
        its position, into the cache in place; (S, k + 1, padded_vocab)
        f32 logits; a moe target's dropped expert assignments a row,
        summed over the layers, into `_v_drops` in place."""
        args = (self.cfg, self.params, self._v_tokens, self._step_pos,
                self._v_ntok, self.cache)
        if self.cfg.moe is None:
            return M.verify_step(*args)[0]
        drops = []
        logits, _ = M.verify_step(*args, drops=drops)
        self._v_drops.copy_(torch.stack(drops).sum(0, dtype=torch.int32))
        return logits

    def _steps(self):
        """(attribute, function, what) of every step the engine keeps."""
        steps = [("_step", self._decode_fn, "the decode step"),
                 ("_remainder_step", self._remainder_fn,
                  "the prefill-remainder step")]
        if self.spec is not None:
            steps.append(("_verify_step", self._verify_fn, "the verify step"))
        return steps

    def _capture(self, steps) -> None:
        """Bind each of `steps`: on the card a CUDA graph of its function,
        captured under the engine's tuning setting (`tuned_cache`), on
        the CPU the function itself. The graphs' pools count the draft's
        graphs too."""
        if self.device.type != "cuda":
            for name, fn, _ in steps:
                setattr(self, name, fn)
            return
        with _tcache.tuned(self.tuned_cache):
            for name, fn, what in steps:
                setattr(self, name, CapturedStep(fn, self.device, what))
        self.graph_pool_bytes = sum(getattr(self, name).pool_bytes
                                    for name, _, _ in self._steps())
        if self.spec is not None:
            self.graph_pool_bytes += self.spec.graph_pool_bytes

    def _build_steps(self) -> None:
        """Make `_step`, `_remainder_step` and, with a draft,
        `_verify_step`: on the card, CUDA graphs of `_decode_fn`,
        `_remainder_fn` and `_verify_fn`, captured while every slot is
        idle (pos = -1, so the warm-ups and captures write no KV row; a
        Mamba state steps only idle rows, which admission overwrites); on
        the CPU, the functions themselves. The capture time counts the
        draft's graphs too."""
        t0 = time.perf_counter()
        self._capture(self._steps())
        if self.device.type == "cuda":
            self.capture_s = time.perf_counter() - t0
            if self.spec is not None:
                self.capture_s += self.spec.capture_s

    def _recurrent_leaves(self):
        """The cache leaves a step writes at any position, an idle slot's
        too: the Mamba state (all of an ssm cache, a hybrid's "mamba")."""
        if self.cfg.family == "ssm":
            return leaves(self.cache)
        if self.cfg.family == "hybrid":
            return leaves(self.cache["mamba"])
        return []

    def _rebuild_steps(self, err: BaseException) -> None:
        """The port's degrade: capture the decode and remainder steps
        again on the same kernels, the old graphs and their pools freed
        first. Slots may be busy. The warm-ups and captures run at every
        position -1 (the next attempt copies the host positions in
        again), so no KV row is written; the Mamba state, which they step
        at any position, is copied out before and back in after (on the
        CPU, where the functions are only bound again, too). Sets
        `degraded`; warns once a process."""
        global _REBUILD_WARNED
        t0 = time.perf_counter()
        steps = self._steps()[:2]
        saved = [(leaf, leaf.clone()) for leaf in self._recurrent_leaves()]
        for name, _, _ in steps:
            step = getattr(self, name)
            if isinstance(step, CapturedStep):
                step.release()
        self._step_pos.fill_(-1)
        self._rem_pos.fill_(-1)
        self._capture(steps)
        for leaf, old in saved:
            leaf.copy_(old)
        self.rebuild_s = time.perf_counter() - t0
        self.degraded = True
        if not _REBUILD_WARNED:
            _REBUILD_WARNED = True
            warnings.warn(
                f"serving engine rebuilt its captured steps on the same "
                f"kernels after {self.kernel_faults} kernel fault(s) (last: "
                f"{err!r}); the trace continues", RuntimeWarning,
                stacklevel=2)

    # -- submission ----------------------------------------------------
    def submit(self, prompt, max_new_tokens: int, *,
               arrival_time: float = 0.0, deadline: Optional[float] = None,
               priority: int = 0, enc_frames=None) -> Request:
        """Queue a request. enc_frames: an encdec request's encoder
        frames, (enc_ctx, d_model) (required there, refused elsewhere)."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size + max_new_tokens > self.max_len:
            raise ValueError(
                f"request (prompt {prompt.size} + gen {max_new_tokens}) "
                f"exceeds the engine's max_len {self.max_len}")
        if self.cfg.family == "encdec":
            want = (self.cfg.enc_ctx, self.cfg.d_model)
            if enc_frames is None:
                raise ValueError(f"encdec requests need enc_frames {want}")
            enc_frames = np.asarray(enc_frames, np.float32)
            if enc_frames.shape != want:
                raise ValueError(f"enc_frames of shape {enc_frames.shape}; "
                                 f"{self.cfg.name} takes {want}")
        elif enc_frames is not None:
            raise ValueError(f"enc_frames are an encdec request's; "
                             f"{self.cfg.name} is {self.cfg.family}")
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
                      max_new_tokens=max_new_tokens,
                      arrival_time=arrival_time, deadline=deadline,
                      priority=priority, enc_frames=enc_frames)
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
        """Dense: the slot's row of every leaf (K and V, a recurrent
        state's leaves, or both), along the leaf's slot axis. Paged: each
        freshly allocated prompt page; pages shared with a resident
        prefix are never rewritten."""
        if self.pool is None:
            for leaf, one, ax in zip(leaves(self.cache), leaves(sub),
                                     self._slot_axes):
                if ax is None:
                    leaf.copy_(one)
                else:
                    leaf.select(ax, slot).copy_(one.select(ax, 0))
            return
        for j, phys in plan.private:
            self._write_page(sub, phys, j * self.page_size)

    # -- admission (prefill path) ---------------------------------------
    def _admit(self, req: Request) -> None:
        """Prefill `req` into a free slot and sample its next token. A
        resumed (preempted) request recomputes its whole context, prompt
        plus the tokens generated before, by its first admission's route:
        the prompt's bucket prefilled, every later token through the
        remainder step (recompute-on-resume)."""
        slot = self.scheduler.admit(req)
        ctx = req.context_tokens()
        plan = None
        if self.pool is not None:
            plan = self.pool.admit_slot(slot, ctx, req.remaining_tokens)
        if req.t_admitted is None:
            req.t_admitted = self._now()
        self._admissions += 1
        t0 = time.perf_counter()

        L = req.prompt_len
        lb = L - (L % self.prefill_chunk) or L   # bucket down; short prompts exact
        tokens = torch.as_tensor(ctx, dtype=torch.long, device=self.device)
        sub = self._sub
        for leaf in leaves(sub):
            leaf.zero_()
        batch = {"tokens": tokens[None, :lb]}
        if req.enc_frames is not None:
            batch["enc_frames"] = torch.as_tensor(
                req.enc_frames, device=self.device)[None]
        logits, _ = M.prefill(self.cfg, self.params, batch, sub)
        for i in range(lb, len(ctx)):    # remainder: one-token steps
            self._rem_token.copy_(tokens[None, i:i + 1])
            self._rem_pos.fill_(i)
            logits = self._remainder_step()
        self._copy_prefill(slot, sub, plan)

        row = logits[0, -1, :self.cfg.vocab].cpu().numpy()   # sync point
        self.prefill_time += time.perf_counter() - t0
        self.prefill_tokens += len(ctx)
        now = self._now()
        if not np.isfinite(row).all():
            self._quarantine(req, slot, now,
                             "non-finite logits at admission prefill")
            return
        tok = self.sampler(row)
        if req.t_first_token is None:
            req.t_first_token = now
        req.generated.append(tok)
        self.tokens_emitted += 1
        if self._done(req, tok):
            self._release(req, slot, now)
        else:
            self._pos[slot] = len(ctx)
            self._tokens[slot, 0] = tok
            if self.spec is not None:
                # the draft's cache rows 0 .. len(ctx) - 1; its first round
                # feeds the pending token at len(ctx)
                self.spec.admit(slot, ctx)

    def _done(self, req: Request, tok: int) -> bool:
        return (req.n_generated >= req.max_new_tokens
                or (self.eos_id is not None and tok == self.eos_id))

    # -- release / cancellation / preemption ----------------------------
    def _free_slot(self, slot: int) -> None:
        if self.pool is not None:
            self.pool.release_slot(slot)
        self._pos[slot] = -1
        self._tokens[slot, 0] = 0

    def _release(self, req: Request, slot: int, now: float,
                 status: str = FINISHED) -> None:
        """Free the slot and its KV pages into a terminal state (shared
        pages drop one reference; their other holders keep the bytes)."""
        self.scheduler.release(slot, status)
        self._free_slot(slot)
        req.t_finished = now

    def _quarantine(self, req: Request, slot: int, now: float,
                    error: str) -> None:
        """End only this request, on a logits row that is not finite."""
        req.error = error
        self.quarantined += 1
        self._release(req, slot, now, QUARANTINED)

    def cancel(self, rid: int) -> bool:
        """Cancel a request by id: a waiter leaves the queue, an active
        request gives up its slot and KV pages at once. Returns False
        when the request is already terminal; raises ValueError for an
        unknown id."""
        req = next((r for r in self.requests if r.rid == rid), None)
        if req is None:
            raise ValueError(f"unknown request id {rid}")
        if req.status in TERMINAL:
            return False
        now = self._now()
        if req.status == WAITING:
            self.scheduler.remove_waiting(req)
            req.status = CANCELLED
            req.t_finished = now
        elif req.status == ACTIVE:
            self._release(req, req.slot, now, CANCELLED)
        self.cancelled += 1
        return True

    def _preempt_slot(self, slot: int) -> None:
        """Send the request in `slot` back to the waiting queue, its pages
        back to the pool. Its resume backoff doubles with each
        preemption, so a starved victim cannot thrash admission."""
        req = self.scheduler.active[slot]
        backoff = self.preempt_backoff * (2 ** req.preemptions)
        req.preemptions += 1
        self.preempted += 1
        self.scheduler.preempt(slot, resume_at=self._now() + backoff)
        self._free_slot(slot)

    def _preempt_for(self, head: Request) -> bool:
        """Preempt a victim so that `head` may be admitted: the
        lowest-priority, then youngest (latest admitted) active request
        with retries left that the head STRICTLY outranks. Equal
        priorities defer (the head waits). False when there is none."""
        cands = [(r.priority, -(r.t_admitted or 0.0), slot)
                 for slot, r in self.scheduler.active.items()
                 if r.preemptions < self.preempt_retry_budget
                 and r.priority < head.priority]
        if not cands:
            return False
        cands.sort()
        self._preempt_slot(cands[0][2])
        return True

    # -- kernel faults and the chaos hooks ------------------------------
    def _run_step(self, step_idx: int) -> torch.Tensor:
        """The decode step over the host tokens and positions, guarded: a
        RuntimeError (a kernel fault, or the injector's) is retried; once
        the faults reach `kernel_fault_threshold` the steps are rebuilt
        first (`_rebuild_steps`). A step that runs out of retries counts
        as crashed and re-raises."""
        attempts = 0
        while True:
            try:
                if self.injector is not None:
                    self.injector.before_kernel(step_idx)
                self._step_tokens.copy_(self._tokens_h, non_blocking=True)
                self._step_pos.copy_(self._pos_h, non_blocking=True)
                return self._step()
            except RuntimeError as e:
                attempts += 1
                self.kernel_faults += 1
                if attempts > self.max_step_retries:
                    self.crashed_steps += 1
                    raise
                if (self.kernel_faults >= self.kernel_fault_threshold
                        and not self.degraded):
                    self._rebuild_steps(e)

    def _poison_slot_cache(self, slot: int) -> None:
        """The chaos hook: NaN a cache region private to `slot`, in place
        in the tensors the captured steps read, so the fault surfaces
        through the attention math. Paged: the slot's current write page
        (made private by `_prepare_pages` just before; a shared page is
        never touched), its K and V, or their scales on an int8 pool.
        Dense: the slot's rows of every float cache leaf."""
        if self.pool is not None:
            phys = int(self.pool.table[slot, int(self._pos[slot])
                                       // self.page_size])
            pages = self.cache["pages"]
            for name in ("k", "v"):
                # int8 pages cannot hold a NaN: poison the scales
                target = name + "s" if name + "s" in pages else name
                pages[target][:, phys].fill_(float("nan"))
            return
        for leaf, ax in zip(leaves(self.cache), self._slot_axes):
            if ax is not None and leaf.is_floating_point():
                leaf.select(ax, slot).fill_(float("nan"))

    # -- decode --------------------------------------------------------
    def _prepare_pages(self, active, n_tok=None) -> None:
        """Make every page an active slot's step writes private before the
        step writes it (positions pos .. pos + n_tok[slot] - 1; one row a
        slot without n_tok): a shared page is copied (CoW), a page past
        the mapped prefix comes from the admission's reservation, which
        covers a whole round; then sync the table. Eager, on the stream
        the step replays on."""
        ps = self.page_size
        for slot in active:
            p0 = int(self._pos[slot])
            p1 = p0 + (1 if n_tok is None else int(n_tok[slot])) - 1
            for j in range(p0 // ps, p1 // ps + 1):
                w = self.pool.prepare_write(slot, j * ps)
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
        if self.injector is not None:
            for slot in self.injector.corrupt_slots(step_idx, tuple(active)):
                self._poison_slot_cache(slot)
        t0 = time.perf_counter()
        logits = self._run_step(step_idx)
        rows = logits[:, -1, :self.cfg.vocab].cpu().numpy()  # sync point
        dt = time.perf_counter() - t0
        self.decode_time += dt
        self._step_times.append(dt)
        self.straggler.observe(step_idx, dt)
        self.decode_steps += 1
        self.decode_slot_steps += len(active)
        self.peak_occupancy = max(self.peak_occupancy, len(active))
        if self.injector is not None:
            rows = self.injector.poison_rows(step_idx, rows, tuple(active))
        now = self._now()
        for slot in sorted(active):
            req = active[slot]
            if not np.isfinite(rows[slot]).all():
                self._quarantine(req, slot, now, f"non-finite logits at "
                                 f"decode step {step_idx}")
                continue
            tok = self.sampler(rows[slot])
            req.generated.append(tok)
            self.tokens_emitted += 1
            if self._done(req, tok):
                self._release(req, slot, now)
            else:
                self._pos[slot] += 1
                self._tokens[slot, 0] = tok

    # -- speculative decode: a draft round and one verify step -----------
    def _spec_decode_once(self) -> None:
        """One round: the draft proposes up to spec_k tokens a slot, the
        verify step scores the pending token and the proposals of every
        slot at once, and the acceptance rule emits 1 .. k + 1 tokens a
        slot (eos cuts a round short). Nothing is rolled back: a rejected
        proposal's cache rows lie past the slot's new pending position,
        where no step attends, and the next round overwrites them."""
        active = self.scheduler.active
        if not active:
            raise ValueError("decode step with no active slots")
        step_idx = self.decode_steps
        k = self.spec_k
        k_vec = np.zeros(self.max_slots, np.int32)
        for slot, req in active.items():
            # a slot near its budget proposes fewer: tokens past max_new
            # would be drafted only to be dropped
            k_vec[slot] = min(k, req.remaining_tokens - 1)
        t0 = time.perf_counter()
        drafts, qprobs = self.spec.draft_round(self._tokens, self._pos,
                                               k_vec)
        vtokens, n_tok = self._vtokens_h.numpy(), self._ntok_h.numpy()
        vtokens[:, 0] = self._tokens[:, 0]
        vtokens[:, 1:] = drafts
        n_tok[:] = np.where(self._pos >= 0, k_vec + 1, 0)
        if self.pool is not None:
            self._prepare_pages(active, n_tok)
        self._v_tokens.copy_(self._vtokens_h, non_blocking=True)
        self._step_pos.copy_(self._pos_h, non_blocking=True)
        self._v_ntok.copy_(self._ntok_h, non_blocking=True)
        logits = self._verify_step()
        rows = logits[:, :, :self.cfg.vocab].cpu().numpy()   # sync point
        drops = self._v_drops.cpu().numpy()
        self.verify_rounds_dropping += bool(drops.any())
        dt = time.perf_counter() - t0
        self.decode_time += dt
        self._step_times.append(dt)
        self.straggler.observe(step_idx, dt)
        self.decode_steps += 1
        self.spec_rounds += 1
        self.decode_slot_steps += len(active)
        self.peak_occupancy = max(self.peak_occupancy, len(active))
        now = self._now()
        for slot in sorted(active):
            req = active[slot]
            nt = int(n_tok[slot])
            if not np.isfinite(rows[slot, :nt]).all():
                self._quarantine(req, slot, now, f"non-finite logits at "
                                 f"decode step {step_idx}")
                continue
            dropped = int(drops[slot, :nt].sum())
            req.verify_dropped += dropped
            self.verify_dropped += dropped
            self.verify_rows += nt
            kk = nt - 1
            emitted, n_acc = self.sampler.speculative_accept(
                rows[slot, :nt], drafts[slot, :kk],
                None if qprobs is None else qprobs[slot, :kk])
            req.draft_proposed += kk
            req.draft_accepted += n_acc
            self.spec_proposed += kk
            self.spec_accepted += n_acc
            n_cons = 0
            finished = False
            for tok in emitted:
                req.generated.append(tok)
                self.tokens_emitted += 1
                n_cons += 1
                if self._done(req, tok):   # eos truncates mid-round
                    finished = True
                    break
            if finished:
                self._release(req, slot, now)
            else:
                self._pos[slot] += n_cons
                self._tokens[slot, 0] = emitted[n_cons - 1]

    # -- driving -------------------------------------------------------
    def step(self) -> bool:
        """Drop the expired waiters, admit every ready request the pool
        can take (preempting for a pool-starved FCFS head where a victim
        exists; otherwise the head waits), then run one decode step (a
        round, with a draft) if any slot is active, all of it under the
        engine's tuning setting (`tuned_cache`), whatever the process's.
        Returns False when all work is drained."""
        with _tcache.tuned(self.tuned_cache):
            return self._step_under_setting()

    def _step_under_setting(self) -> bool:
        while True:
            now = self._now()
            for req in self.scheduler.drop_expired(now):
                req.t_finished = now
                self.expired += 1
            req = self.scheduler.next_admission(now)
            if req is None:
                break
            if self.pool is not None:
                # a denied admission takes the pool as exhausted
                denied = (self.injector is not None and
                          self.injector.deny_admission(self._admissions))
                ok = not denied and self.pool.can_admit(
                    req.context_tokens(), req.remaining_tokens)
                while not ok and self._preempt_for(req):
                    ok = self.pool.can_admit(req.context_tokens(),
                                             req.remaining_tokens)
                if not ok:
                    break           # the head waits for pages to free
            self._admit(req)
        if self.scheduler.n_active:
            if self.spec is not None:
                self._spec_decode_once()
            else:
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
        n_emitted = sum(r.n_generated for r in self.requests)
        assert n_emitted == self.tokens_emitted, \
            (n_emitted, self.tokens_emitted)
        waits = [r.t_admitted - r.arrival_time for r in self.requests
                 if r.t_admitted is not None]
        # goodput: only the tokens of requests that FINISHED (by their
        # deadline, where they had one) were worth emitting; a resume's
        # recomputation shows in prefill_tokens, never as a token twice
        useful = sum(r.n_generated for r in done
                     if r.missed_deadline is not True)
        deadlined = [r for r in self.requests
                     if r.deadline is not None and r.status in TERMINAL]
        missed = [r for r in deadlined if r.missed_deadline]
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
            "decode_step_p50_s": percentile(self._step_times, 50),
            "decode_step_p99_s": percentile(self._step_times, 99),
            "admission_wait_p50_s": percentile(waits, 50),
            "admission_wait_p99_s": percentile(waits, 99),
            "expired": self.expired,
            "cancelled": self.cancelled,
            "preempted": self.preempted,
            "quarantined": self.quarantined,
            "kernel_faults": self.kernel_faults,
            "crashed_steps": self.crashed_steps,
            "degraded": self.degraded,
            "straggler_steps": len(self.straggler.flagged),
            "useful_tokens": useful,
            "goodput": useful / max(self.tokens_emitted, 1),
            "deadline_miss_rate": (len(missed) / len(deadlined)
                                   if deadlined else float("nan")),
            # tokens a slot-step: 1.0 for plain decode (less quarantines),
            # above it when speculation pays
            "tokens_per_step": decode_tokens / max(self.decode_slot_steps, 1),
        }
        if self.spec is not None:
            out["spec_rounds"] = self.spec_rounds
            out["spec_proposed"] = self.spec_proposed
            out["spec_accepted"] = self.spec_accepted
            out["spec_acceptance_rate"] = (self.spec_accepted
                                           / max(self.spec_proposed, 1))
            out["draft_time_s"] = self.spec.draft_time
            out["draft_prefill_time_s"] = self.spec.prefill_time
            if self.cfg.moe is not None:
                out["verify_dropped"] = self.verify_dropped
                out["verify_dropped_frac"] = self.verify_dropped / max(
                    self.verify_rows * self.cfg.moe.top_k * self.cfg.n_layers,
                    1)
                out["verify_rounds_dropping"] = self.verify_rounds_dropping
        if self.injector is not None:
            out["faults_injected"] = self.injector.report()
        if self.pool is not None:
            out["kv_pool"] = self.pool.report()
        return out
