"""Host-side page pool for the paged KV cache (the JAX package's
`repro/serving/kv_pool.py`, kept here as the port's own copy).

The serving engine's dense cache spends ``max_slots * max_len`` rows of
HBM whether or not a slot ever reaches ``max_len``; this module replaces
that with a fixed pool of ``(page_size, heads, head_dim)`` K/V pages and
a per-slot page table, so capacity is bounded by *tokens actually
resident* rather than by the worst case. Two mechanisms pay for the
indirection:

* **Prefix sharing.** Prompt pages are content-hashed at admission with
  a prefix-chained digest (page j's digest folds in page j-1's), so two
  requests sharing a system prompt map the same physical pages and pay
  for them once. The final *partial* prompt page participates too — its
  digest folds in the token count, so "same 40-token prefix" matches
  while "same 32 tokens then diverges" does not.
* **Copy-on-write.** A decode write into a page with refcount > 1 first
  copies it to a fresh page and retargets the writer's table entry; the
  sharers keep the original bytes. Stale generated-token rows inherited
  by a CoW copy are harmless: writers fill positions contiguously from
  their prompt length, and the decode kernel masks ``k_pos <= pos``, so
  every stale row is overwritten before it is ever attended to.

The pool is pure host bookkeeping (numpy table, refcounts, free list);
the engine owns the device arrays and performs the copies the pool's
directives describe. Accounting is conservative: admission reserves a
page for every position the request may ever write into a page it does
not privately own, so ``prepare_write`` can never fail mid-stream — a
request is either refused up front (``KVPoolExhausted``) or guaranteed
to finish.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field

import numpy as np

__all__ = ["AdmitPlan", "KVPagePool", "KVPoolExhausted", "PageWrite"]


class KVPoolExhausted(RuntimeError):
    """Admission refused: the pool cannot guarantee the request's full
    write range. Raised at admission only — never mid-decode."""


@dataclass(frozen=True)
class AdmitPlan:
    """What admission decided for one slot: which logical prompt pages
    landed on shared physical pages (already populated — the engine must
    NOT write them) and which were freshly allocated (the engine fills
    them from its prefill)."""

    slot: int
    shared: tuple[tuple[int, int], ...]    # (logical_page, phys_page)
    private: tuple[tuple[int, int], ...]   # (logical_page, phys_page)


@dataclass(frozen=True)
class PageWrite:
    """Directive from ``prepare_write``: before writing position ``pos``
    the engine must either zero-init a fresh page (``kind="alloc"``) or
    device-copy ``src`` into ``dst`` (``kind="cow"``). The table row is
    already retargeted when this is returned."""

    kind: str                              # "alloc" | "cow"
    logical: int
    dst: int
    src: int | None = None


@dataclass
class _Stats:
    admitted: int = 0
    refused: int = 0
    shared_page_hits: int = 0
    cow_copies: int = 0
    pages_allocated: int = 0
    peak_resident: int = 0
    peak_sharing: float = 1.0


class KVPagePool:
    """Bookkeeping for a fixed pool of KV pages shared by all slots.

    Parameters
    ----------
    n_pages:        physical pool size (per layer; the table is shared
                    across layers, so one logical page is the same
                    physical index in every layer's pool).
    page_size:      tokens per page.
    max_slots:      page-table rows.
    pages_per_slot: page-table width — ``max_len // page_size``.
    """

    def __init__(self, n_pages: int, page_size: int, max_slots: int,
                 pages_per_slot: int):
        if n_pages < 1 or page_size < 1:
            raise ValueError("n_pages and page_size must be positive")
        self.n_pages = int(n_pages)
        self.page_size = int(page_size)
        self.max_slots = int(max_slots)
        self.pages_per_slot = int(pages_per_slot)
        # -1 = unmapped; the kernel's index map clamps to page 0 and the
        # causal mask hides whatever it streams.
        self.table = np.full((max_slots, pages_per_slot), -1, np.int32)
        self.refcount = np.zeros(n_pages, np.int64)
        self._free: list[int] = list(range(n_pages - 1, -1, -1))
        # digest -> phys page for shareable (prompt-only) pages, plus
        # the reverse map so a freed page drops out of the registry.
        self._by_hash: dict[bytes, int] = {}
        self._hash_of: dict[int, bytes] = {}
        # pages the slot may still need for writes it has not issued yet
        self._reserved = np.zeros(max_slots, np.int64)
        self.version = 0        # bumped on every table mutation
        self.stats = _Stats()

    # ---------------------------------------------------------- helpers

    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def n_reserved(self) -> int:
        return int(self._reserved.sum())

    def _alloc(self) -> int:
        if not self._free:
            # Reservations make this unreachable for admitted requests;
            # reaching it means the accounting is broken.
            raise KVPoolExhausted(
                "internal error: free list empty despite reservation")
        p = self._free.pop()
        self.refcount[p] = 1
        self.stats.pages_allocated += 1
        return p

    def _release_page(self, p: int) -> None:
        if self.refcount[p] <= 0:
            # A slot-level double release is a harmless no-op (the table
            # row is already -1); reaching a page twice means a table /
            # refcount divergence — fail loudly instead of corrupting
            # the free list.
            raise ValueError(
                f"double release of page {p} (refcount "
                f"{int(self.refcount[p])})")
        self.refcount[p] -= 1
        if self.refcount[p] == 0:
            h = self._hash_of.pop(p, None)
            if h is not None:
                self._by_hash.pop(h, None)
            self._free.append(p)

    @staticmethod
    def _page_digests(tokens, page_size: int) -> list[bytes]:
        """Prefix-chained digest per prompt page (partial tail page
        included; its digest folds in the token count so prefixes of
        different lengths inside one page never collide)."""
        toks = np.asarray(tokens, np.int32)
        out, prev = [], b""
        for start in range(0, len(toks), page_size):
            chunk = toks[start:start + page_size]
            h = hashlib.sha1(prev + np.int64(len(chunk)).tobytes()
                             + chunk.tobytes()).digest()
            out.append(h)
            prev = h
        return out

    def _plan(self, tokens, max_new: int):
        """(digests, shared phys per prompt page or None, need_now,
        reserve) — the dry-run shared by can_admit and admit_slot."""
        ps = self.page_size
        n_tok = len(tokens)
        last = n_tok + max(0, int(max_new)) - 1
        if last // ps >= self.pages_per_slot:
            raise KVPoolExhausted(
                f"request needs page {last // ps} but the table is only "
                f"{self.pages_per_slot} pages wide")
        digests = self._page_digests(tokens, ps)
        hits = [self._by_hash.get(h) for h in digests]
        need_now = sum(1 for p in hits if p is None)
        # Write range [n_tok, last]: reserve one page for EVERY page in
        # it. Beyond-prompt pages cost an alloc; the partial tail prompt
        # page (the only prompt page that can overlap the range) may
        # cost a CoW even when privately owned at admission — it sits in
        # the hash registry, so a later request can share it and turn
        # the owner's next write into a copy. Tail reservations that end
        # up unused (the page never gets shared) are held until release:
        # one page of pessimism per active slot buys the guarantee that
        # prepare_write never fails.
        first_w, last_w = n_tok // ps, last // ps
        reserve = last_w - first_w + 1 if max_new > 0 else 0
        return digests, hits, need_now, reserve

    # ------------------------------------------------------------ admit

    def can_admit(self, tokens, max_new: int) -> bool:
        """True iff ``admit_slot`` would succeed right now."""
        try:
            _, _, need_now, reserve = self._plan(tokens, max_new)
        except KVPoolExhausted:
            return False
        return self.n_free - self.n_reserved >= need_now + reserve

    def admit_slot(self, slot: int, tokens, max_new: int) -> AdmitPlan:
        """Map slot's prompt pages (sharing where digests match) and
        reserve its full write range. Raises KVPoolExhausted when the
        pool cannot guarantee the request end-to-end."""
        if np.any(self.table[slot] >= 0) or self._reserved[slot]:
            raise ValueError(f"slot {slot} already mapped")
        digests, hits, need_now, reserve = self._plan(tokens, max_new)
        if self.n_free - self.n_reserved < need_now + reserve:
            self.stats.refused += 1
            raise KVPoolExhausted(
                f"need {need_now} pages now + {reserve} reserved, pool has "
                f"{self.n_free} free ({self.n_reserved} already reserved)")
        shared, private = [], []
        for j, (h, hit) in enumerate(zip(digests, hits)):
            if hit is not None:
                self.refcount[hit] += 1
                self.table[slot, j] = hit
                shared.append((j, hit))
                self.stats.shared_page_hits += 1
            else:
                p = self._alloc()
                self.table[slot, j] = p
                self._by_hash[h] = p
                self._hash_of[p] = h
                private.append((j, p))
        self._reserved[slot] = reserve
        self.version += 1
        self.stats.admitted += 1
        self.stats.peak_resident = max(self.stats.peak_resident,
                                       int((self.refcount > 0).sum()))
        self.stats.peak_sharing = max(self.stats.peak_sharing,
                                      self.sharing_ratio())
        return AdmitPlan(slot, tuple(shared), tuple(private))

    # ------------------------------------------------------------ write

    def prepare_write(self, slot: int, pos: int) -> PageWrite | None:
        """Make position ``pos`` of ``slot`` privately writable. Returns
        the copy/alloc directive the engine must execute on the device
        arrays, or None when the page is already private."""
        j = int(pos) // self.page_size
        phys = int(self.table[slot, j])
        if phys < 0:
            dst = self._alloc()
            self.table[slot, j] = dst
            self._reserved[slot] = max(0, self._reserved[slot] - 1)
            self.version += 1
            return PageWrite("alloc", j, dst)
        if self.refcount[phys] > 1:
            dst = self._alloc()
            self.refcount[phys] -= 1
            self.table[slot, j] = dst
            self._reserved[slot] = max(0, self._reserved[slot] - 1)
            self.version += 1
            self.stats.cow_copies += 1
            return PageWrite("cow", j, dst, src=phys)
        return None

    # ---------------------------------------------------------- release

    def release_slot(self, slot: int) -> None:
        """Drop all of slot's references; pages reaching refcount 0 go
        back to the free list (and out of the hash registry)."""
        for j in range(self.pages_per_slot):
            p = int(self.table[slot, j])
            if p >= 0:
                self._release_page(p)
                self.table[slot, j] = -1
        self._reserved[slot] = 0
        self.version += 1

    # ------------------------------------------------------------ stats

    def sharing_ratio(self) -> float:
        """Logical mapped pages per physical resident page (> 1 means
        prefix sharing is active)."""
        logical = int((self.table >= 0).sum())
        physical = int((self.refcount > 0).sum())
        return logical / physical if physical else 1.0

    def report(self) -> dict:
        s = self.stats
        return {
            "n_pages": self.n_pages,
            "page_size": self.page_size,
            "pages_free": self.n_free,
            "pages_reserved": self.n_reserved,
            "pages_resident": int((self.refcount > 0).sum()),
            "sharing_ratio": self.sharing_ratio(),
            "admitted": s.admitted,
            "refused": s.refused,
            "shared_page_hits": s.shared_page_hits,
            "cow_copies": s.cow_copies,
            "pages_allocated": s.pages_allocated,
            "peak_resident": s.peak_resident,
            "peak_sharing_ratio": s.peak_sharing,
        }
