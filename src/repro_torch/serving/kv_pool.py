"""Paged KV pool: one device allocation per tier and a host-side
reference-counted page allocator with a content-addressed prefix index and
copy-on-write.  The port's copy of the reference's ``serving/kv_pool.py``,
for bf16, float32 and int8 pages (an int8 pool carries one float32 scale
row per physical page, which moves with its page).

The pool replaces the drain path's per-(batch, bucket) contiguous caches with
one physical allocation per tier, ``model_zoo.init_paged_cache``: K/V is cut
into ``num_pages`` pages of ``page_size`` positions, and an int32 block table
maps each decode slot's logical pages to physical ones.  The device pools are
updated in place by the scheduler's tick (the reference donates them).

Ownership.  A physical page carries a refcount: one per decode slot whose
block row references it, one per prefix-index entry that retains it.  It
returns to the free list only at zero.  Full prompt pages are
content-addressed by a rolling chain hash (``batcher.prompt_hashes``), so
looking up a new prompt walks its chain until the first miss and aliases
every hit page read-only into the new slot's block row.  A completed prompt
also registers a full-prompt entry that pins every prompt page and one row
of the device prefix cache (its last-position logits and, for the
recurrent families, the state at the prompt's end), so a later identical
prompt restores and skips prefill.  The recurrent families share whole
prompts only (``partial_prefix``).

Copy-on-write.  A slot writes only pages it holds exclusively.  When a
full-prompt restore would append into a retained partial tail page,
admission takes a fresh page and schedules a page copy (``cow`` pairs run at
the top of the tick, before prefill); ``write_block`` masks every
non-exclusive page to the null page for the decode append, so a violated
invariant drops the write instead of corrupting another request.

Chunked prompts.  A prompt that the chunk lane feeds over several ticks
registers nothing at admission: ``register_written`` indexes each full
prompt page once a tick has written it, visible from the next tick, so a
slot released mid-prompt leaves only pages that hold their K/V.

Eviction is LRU over index entries, kept as a heap of (used, kind, hash)
that each use pushes to, so an eviction pops the least recently used
entries instead of sorting the index; pages referenced by live slots never
move.  Page 0 is the null page: freed block-table rows and idle slots point
at it and no positional mask ever exposes it.

Block-table width.  The reference bounds a slot's block-table row at
``MAX_PREFETCH_PAGES = 2048`` because its TPU kernels scalar-prefetch the
row into SMEM.  The port's CUDA kernels read the row from global memory
page by page, so the row width needs no bound of its own; the only limit is
that positions and page ids stay int32, which the pool's sizes keep.

``kv_bits`` reports 8 for int8 pools and 16 for bf16, as the reference
does; a float32 pool, which the reference never builds for serving,
reports 32.
"""
from __future__ import annotations

import heapq
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import DENSE, MOE, VLM, ModelConfig
from repro_torch.models import model_zoo
from repro_torch.models.transformer import page_tensors


@dataclass
class _PageEntry:
    """One content-addressed full prompt page retained by the index."""
    page: int
    ready: int          # first tick whose lookups may alias this page
    used: int           # LRU stamp


@dataclass
class _FullEntry:
    """One full-prompt snapshot: pinned prompt pages + a prefix-cache row."""
    row: int            # row in the device prefix cache (logits / state)
    pages: List[int]    # every prompt page incl. the partial tail (pinned)
    bucket: int
    ready: int
    used: int


@dataclass
class AdmitPlan:
    """Host-side admission decision for one request (consumed by the tick).

    ``start``     — first token position the admit lane must prefill (page
                    aligned for partial hits; == bucket for full restores);
    ``restore_row`` — prefix-cache row to restore from (-1 = none);
    ``save_row``    — prefix-cache row this admission fills (-1 = none);
    ``cow``         — (src, dst) physical page copy to run before prefill.
    """
    slot: int
    start: int = 0
    restore_row: int = -1
    save_row: int = -1
    cow: Optional[Tuple[int, int]] = None

    @property
    def is_restore(self) -> bool:
        return self.restore_row >= 0


class KVPool:
    """Device page pool + block tables + refcounted allocator for one tier.

    ``buffers`` holds the (L, P, page, K, Dh) ``kp``/``vp`` pools the
    scheduler's tick updates in place; ``prefix_buffers`` (present when
    ``prefix_entries > 0``) holds the device-side prefix cache rows;
    ``block`` is the host-side (num_slots, n_pages) int32 block table passed
    as a small operand each tick.
    """

    def __init__(self, cfg: ModelConfig, num_slots: int, max_context: int,
                 page_size: int = 16, num_pages: Optional[int] = None,
                 dtype=torch.bfloat16, prefix_entries: int = 0,
                 device="cuda", alloc: bool = True):
        if max_context % page_size:
            raise ValueError(f"max_context {max_context} must be a multiple "
                             f"of page_size {page_size}")
        # page-granular partial hits need per-position attention pages; the
        # recurrent families (SSM, and the hybrid's mamba half) have no state
        # snapshot at mid-prompt boundaries, so they share whole prompts only
        self.partial_prefix = cfg.family in (DENSE, VLM, MOE)
        self.cfg = cfg
        self.num_slots = num_slots
        self.page_size = page_size
        self.n_pages_per_slot = max_context // page_size
        if num_pages is None:
            # enough for every slot to hold a full-context sequence, + null
            num_pages = num_slots * self.n_pages_per_slot + 1
        if num_pages < 2:
            raise ValueError("need at least one non-null page")
        self.num_pages = num_pages
        # ``alloc=False`` (mesh serving): this pool is the host-side
        # allocator of an S replica that another rank runs (free list,
        # block table, refcounts, prefix index); its buffers are ``meta``
        # tensors, shapes and dtypes only, which every host-side reader
        # (gauges, byte counts, check_invariants) is content with
        if not alloc:
            device = "meta"
        self.buffers = model_zoo.init_paged_cache(
            cfg, num_slots, num_pages, page_size, dtype, device)
        self.kv_dtype = str(dtype).replace("torch.", "")
        # byte accounting over the pool allocation (pages, int8 scale rows,
        # recurrent state rows), fixed at construction
        self.kv_bytes_total = int(sum(b.numel() * b.element_size()
                                      for b in self.buffers.values()))
        self.bytes_per_slot = self.kv_bytes_total // num_slots
        self.prefix_entries = prefix_entries
        self.prefix_buffers = (
            model_zoo.init_prefix_cache(cfg, prefix_entries, device)
            if prefix_entries > 0 else None)
        self.block = np.zeros((num_slots, self.n_pages_per_slot), np.int32)
        # LIFO free list; physical page 0 is the null page, never allocated
        self._free: List[int] = list(range(num_pages - 1, 0, -1))
        self._refs = np.zeros((num_pages,), np.int32)       # all references
        self._slot_refs = np.zeros((num_pages,), np.int32)  # slot refs only
        self._slot_pages: Dict[int, List[int]] = {}
        self._page_index: Dict[bytes, _PageEntry] = {}
        self._full_index: Dict[bytes, _FullEntry] = {}
        self._row_free: List[int] = list(range(prefix_entries - 1, -1, -1))
        # both indexes' LRU order: (used, kind, hash), kind 0 a page entry
        # and 1 a full entry, pushed at each use; an item whose entry is
        # gone or was used again since is stale, dropped when it surfaces
        self._lru: List[Tuple[int, int, bytes]] = []
        # ``chunk_registered``: pages the chunk lane indexed as it wrote them
        self.stats: Dict[str, int] = {
            "hits": 0, "full_hits": 0, "tokens_saved": 0, "cow_copies": 0,
            "evictions": 0, "chunk_registered": 0}

    # -- allocator ----------------------------------------------------------

    @property
    def free_pages(self) -> int:
        return len(self._free)

    def gauges(self) -> Dict[str, int]:
        """Telemetry snapshot of allocator state the host already holds —
        sampled once per scheduler tick, no device traffic."""
        return {
            "free_pages": len(self._free),
            "refcount_total": int(self._refs.sum()),
            "prefix_index": len(self._page_index) + len(self._full_index),
            "cow_copies": self.stats["cow_copies"],
            # pool-footprint gauges (constant per pool; numeric so the
            # Chrome-trace exporter tracks them as counter series)
            "kv_bytes_total": self.kv_bytes_total,
            "bytes_per_slot": self.bytes_per_slot,
            "kv_bits": {"int8": 8, "bfloat16": 16}.get(self.kv_dtype, 32),
        }

    @property
    def held_slots(self) -> List[int]:
        """Slots currently holding pages — empty after a clean drain.  The
        fault-path tests assert this: every abandoned escalation (lost,
        expired, outage-aborted, or in flight when the run drains) must have
        released its pages through ``free``/``retract``."""
        return sorted(self._slot_pages)

    def pages_needed(self, context_len: int) -> int:
        return -(-context_len // self.page_size)        # ceil div

    def can_alloc(self, context_len: int, tick: Optional[int] = None) -> bool:
        """Optimistic capacity check: free pages plus what eviction could
        reclaim (index-retained pages with no slot refs; entries still
        PENDING at ``tick`` are excluded, matching eviction's own rule).
        ``alloc``/``admit_prefix`` remain the authority — admission paths
        treat their failure as backpressure and retry."""
        n = self.pages_needed(context_len)
        return n <= len(self._free) + self._reclaimable(tick)

    def _pop_page(self, slot: int) -> int:
        p = self._free.pop()
        self._refs[p] += 1
        self._slot_refs[p] += 1
        self._slot_pages[slot].append(p)
        return p

    def _alias_page(self, slot: int, page: int) -> int:
        self._refs[page] += 1
        self._slot_refs[page] += 1
        self._slot_pages[slot].append(page)
        return page

    def alloc(self, slot: int, context_len: int,
              tick: Optional[int] = None) -> None:
        """Give ``slot`` enough EXCLUSIVE pages for ``context_len`` positions;
        the rest of its block-table row points at the null page."""
        if not 0 <= slot < self.num_slots:
            raise ValueError(f"slot {slot} out of range (0..{self.num_slots - 1})")
        if slot in self._slot_pages:
            raise ValueError(f"slot {slot} already holds pages")
        n = self.pages_needed(context_len)
        if n > self.n_pages_per_slot:
            raise ValueError(
                f"context {context_len} needs {n} pages > per-slot maximum "
                f"{self.n_pages_per_slot}")
        if n > len(self._free) and not self._evict_pages(n, tick=tick):
            raise ValueError(
                f"pool exhausted: need {n} pages, {len(self._free)} free")
        self._slot_pages[slot] = []
        pages = [self._pop_page(slot) for _ in range(n)]
        self.block[slot, :] = 0
        self.block[slot, :n] = pages

    def free(self, slot: int) -> None:
        """Drop ``slot``'s references; pages whose refcount hits zero return
        to the free list.  Stale page contents are never scrubbed — the
        positional mask plus the prefill overwrite make them unobservable to
        the next owner.  Double frees and frees of foreign/unknown slots
        raise instead of corrupting the free list."""
        if not 0 <= slot < self.num_slots:
            raise ValueError(f"slot {slot} out of range (0..{self.num_slots - 1})")
        pages = self._slot_pages.pop(slot, None)
        if pages is None:
            raise ValueError(f"double free: slot {slot} holds no pages")
        for p in reversed(pages):
            if self._refs[p] <= 0 or self._slot_refs[p] <= 0:
                raise ValueError(
                    f"foreign free: page {p} of slot {slot} is not held "
                    f"(refcount underflow)")
            self._refs[p] -= 1
            self._slot_refs[p] -= 1
            if self._refs[p] == 0:
                self._free.append(p)
        self.block[slot, :] = 0

    def owned(self, slot: int) -> List[int]:
        return list(self._slot_pages.get(slot, []))

    def truncate(self, slot: int, length: int) -> None:
        """Rewind guard for the speculative rollback: verify that moving
        ``slot``'s write position back to ``length`` can never append into a
        page another slot can SEE.  Every page of the slot's block row from
        the one covering position ``length`` onward must be held by exactly
        this one slot (``slot_refs == 1``) — a co-resident alias there would
        mean the rolled-back decode could overwrite positions another request
        reads, so this RAISES instead of proceeding (copy-on-write
        territory; admission guarantees the decode region is freshly
        allocated, making this pure defense in depth).  A prefix-INDEX
        retention on the partial prompt-tail page is fine: index readers
        only ever alias prompt offsets, restores copy-on-write before
        appending, and the rewound writer (length > prompt) never touches
        prompt offsets — the same invariant the normal append path relies
        on.  Refcounts are unchanged: the slot keeps its allocation and the
        stale tail contents are shadowed by the positional mask, exactly
        like the drain path's discarded overrun steps."""
        if not 0 <= slot < self.num_slots:
            raise ValueError(
                f"slot {slot} out of range (0..{self.num_slots - 1})")
        if slot not in self._slot_pages:
            raise ValueError(f"truncate: slot {slot} holds no pages")
        if length < 0:
            raise ValueError(f"truncate to negative length {length}")
        held = self._slot_pages[slot]
        first = length // self.page_size
        for p in self.block[slot, first:]:
            if p == 0:
                continue
            if self._slot_refs[p] != 1 or p not in held:
                raise ValueError(
                    f"truncate would rewind slot {slot} into shared page "
                    f"{int(p)} (slot_refs={int(self._slot_refs[p])}): "
                    f"copy-on-write required")

    # -- prefix index -------------------------------------------------------

    def _reclaimable(self, tick: Optional[int] = None) -> int:
        """Pages that eviction could free: index-retained, no slot refs.
        Pending entries (``ready > tick``) are not evictable, so their pages
        don't count when a tick is given."""
        pages = set()
        pending = set()
        for e in self._page_index.values():
            (pages if tick is None or e.ready <= tick else pending).add(e.page)
        for e in self._full_index.values():
            (pages if tick is None or e.ready <= tick
             else pending).update(e.pages)
        return sum(1 for p in pages - pending if self._slot_refs[p] == 0
                   and self._refs[p] > 0)

    def _evict_pages(self, need: int, tick: Optional[int] = None) -> bool:
        """Evict LRU index entries until at least ``need`` pages are free.
        Entries whose pages are still slot-referenced release only the index
        pin (the pages stay with their slots).  PENDING entries (registered
        this tick, device write still in flight) are never evicted — their
        prefix-cache row would be double-booked mid-dispatch.  Entries are
        taken in (used, kind, hash) order, least recently used first; the
        ones skipped go back on the heap."""
        skipped = set()
        while len(self._free) < need and self._lru:
            item = heapq.heappop(self._lru)
            used, kind, h = item
            e = (self._full_index if kind else self._page_index).get(h)
            if e is None or e.used != used or item in skipped:
                continue                        # stale
            # only evict entries that can contribute pages: an entry whose
            # every page is still slot-referenced frees nothing — dropping it
            # would wipe retention without making progress (the slots, not
            # the index, are what's holding the pool)
            if (tick is not None and e.ready > tick) or all(
                    self._slot_refs[p] > 0
                    for p in (e.pages if kind else (e.page,))):
                skipped.add(item)
                continue
            if kind:
                self._drop_full_entry(h)
            else:
                self._drop_page_entry(h)
            self.stats["evictions"] += 1
        for item in skipped:
            heapq.heappush(self._lru, item)
        return len(self._free) >= need

    def _stamp(self, kind: int, h: bytes, e, tick: int) -> None:
        """Mark index entry ``e`` (``kind`` 0 page, 1 full) used at
        ``tick``."""
        if e.used != tick:                  # else its item is on the heap
            e.used = tick
            self._push(kind, h, e)

    def _push(self, kind: int, h: bytes, e) -> None:
        """Put ``e``'s (used, kind, hash) on the LRU heap; the heap is
        rebuilt from the live entries once stale items outnumber them."""
        heapq.heappush(self._lru, (e.used, kind, h))
        live = len(self._page_index) + len(self._full_index)
        if len(self._lru) > 2 * live + 64:
            self._lru = [(x.used, 0, k) for k, x in self._page_index.items()]
            self._lru += [(x.used, 1, k) for k, x in self._full_index.items()]
            heapq.heapify(self._lru)

    def _index_page(self, h: bytes, page: int, ready: int, tick: int) -> None:
        """Retain ``page`` in the page index under ``h``."""
        self._refs[page] += 1
        self._page_index[h] = _PageEntry(page, ready=ready, used=tick)
        self._push(0, h, self._page_index[h])

    def register_written(self, slot: int, page_hashes: Sequence[bytes],
                         bucket: int, fed: int, written: int,
                         tick: int) -> None:
        """Index the full prompt pages (``i < bucket // page_size``, the
        admit lane's rule) that ``slot``'s chunk-lane row completed by
        writing the prompt positions [``fed``, ``written``); hashes already
        indexed are skipped.  ``tick`` is the one after the tick that wrote
        them, the first whose lookups may alias them."""
        page = self.page_size
        for i in range(fed // page, min(written // page, bucket // page)):
            if page_hashes[i] not in self._page_index:
                self._index_page(page_hashes[i], int(self.block[slot, i]),
                                 ready=tick, tick=tick)
                self.stats["chunk_registered"] += 1

    def _unref(self, page: int) -> None:
        self._refs[page] -= 1
        if self._refs[page] == 0:
            self._free.append(page)

    def _drop_page_entry(self, h: bytes) -> None:
        e = self._page_index.pop(h)
        self._unref(e.page)

    def _drop_full_entry(self, h: bytes) -> None:
        e = self._full_index.pop(h)
        for p in e.pages:
            self._unref(p)
        self._row_free.append(e.row)

    def lookup(self, page_hashes: Sequence[bytes], full_hash: bytes,
               bucket: int, tick: int) -> Tuple[Optional[_FullEntry], List[int]]:
        """Longest cached prefix of a prompt.  Returns (full_entry | None,
        hit pages).  Only entries whose fill tick has completed are visible
        (``ready <= tick``), so two identical prompts admitted in the same
        tick never alias pages still being written.  The hit walk is capped
        so at least one prompt position is always left to prefill — the
        admit lane must produce last-position logits for a partial hit."""
        fe = self._full_index.get(full_hash)
        if fe is not None and fe.ready <= tick and fe.bucket == bucket:
            self._stamp(1, full_hash, fe, tick)
            return fe, list(fe.pages)
        max_pages = ((bucket - 1) // self.page_size if self.partial_prefix
                     else 0)
        pages: List[int] = []
        for h in page_hashes[:max_pages]:
            e = self._page_index.get(h)
            if e is None or e.ready > tick:
                break
            self._stamp(0, h, e, tick)
            pages.append(e.page)
        return None, pages

    def admit_prefix(self, slot: int, context_len: int, bucket: int,
                     page_hashes: Optional[Sequence[bytes]],
                     full_hash: Optional[bytes], tick: int, *,
                     register: bool = True) -> Optional[AdmitPlan]:
        """Admission with prefix reuse: alias the longest cached prefix into
        ``slot``'s block row, allocate fresh pages for the rest, and decide
        restore / save / copy-on-write.  Returns None (no side effects) when
        even eviction cannot produce enough fresh pages.

        ``register=False`` (chunked-prefill admission): the prompt's pages
        fill over SEVERAL ticks, so neither the page index nor a full-prompt
        entry may advertise them at ``tick + 1`` — the admission still READS
        cached prefixes (aliasing, ``plan.start``) but retains nothing; the
        chunk lane indexes each page once written (``register_written``)."""
        if not 0 <= slot < self.num_slots:
            raise ValueError(f"slot {slot} out of range (0..{self.num_slots - 1})")
        if slot in self._slot_pages:
            raise ValueError(f"slot {slot} already holds pages")
        if page_hashes is None or full_hash is None:
            try:
                self.alloc(slot, context_len, tick=tick)
            except ValueError:
                return None
            return AdmitPlan(slot=slot)
        n_ctx = self.pages_needed(context_len)
        if n_ctx > self.n_pages_per_slot:
            raise ValueError(
                f"context {context_len} needs {n_ctx} pages > per-slot "
                f"maximum {self.n_pages_per_slot}")
        fe, hit = self.lookup(page_hashes, full_hash, bucket, tick)
        n_alias = len(hit) if fe is None else bucket // self.page_size
        # alias the hit pages FIRST — the slot reference pins them so the
        # eviction pass below can never reclaim a page we are about to use
        self._slot_pages[slot] = []
        row: List[int] = []
        plan = AdmitPlan(slot=slot)
        for p in (hit if fe is None else fe.pages[: n_alias]):
            row.append(self._alias_page(slot, p))
        if not self._evict_pages(n_ctx - n_alias, tick=tick):
            for p in reversed(self._slot_pages.pop(slot)):   # rollback
                self._refs[p] -= 1
                self._slot_refs[p] -= 1
                if self._refs[p] == 0:
                    self._free.append(p)
            return None
        if fe is not None:
            # full restore: every FULL prompt page is aliased; the partial
            # tail page (decode appends into it) is copy-on-write; fresh
            # pages cover the decode region
            tail = bucket % self.page_size
            if tail:
                dst = self._pop_page(slot)
                row.append(dst)
                plan.cow = (fe.pages[-1], dst)
                self.stats["cow_copies"] += 1
            while len(row) < n_ctx:
                row.append(self._pop_page(slot))
            plan.start = bucket
            plan.restore_row = fe.row
            self.stats["full_hits"] += 1
            self.stats["hits"] += 1
            self.stats["tokens_saved"] += bucket
        else:
            plan.start = len(hit) * self.page_size
            if hit:
                self.stats["hits"] += 1
                self.stats["tokens_saved"] += plan.start
            # fresh pages for the uncached prompt suffix; register the FULL
            # ones in the page index (their content lands this tick, usable
            # from the next)
            n_full = (bucket // self.page_size
                      if self.partial_prefix and register else 0)
            for i in range(len(row), n_ctx):
                p = self._pop_page(slot)
                row.append(p)
                if i < n_full and page_hashes[i] not in self._page_index:
                    self._index_page(page_hashes[i], p, ready=tick + 1,
                                     tick=tick)
            if register:
                plan.save_row = self._reserve_full_entry(
                    full_hash, row, bucket, tick)
        self.block[slot, :] = 0
        self.block[slot, : len(row)] = row
        return plan

    def retract(self, slot: int, page_hashes: Optional[Sequence[bytes]],
                full_hash: Optional[bytes], tick: int) -> None:
        """Undo the index registrations a SAME-TICK admission made, for an
        admission that is being rolled back before its tick ran (paired
        speculative admission where the partner tier failed).  Registered
        entries become visible at ``tick + 1``; any entry for this prompt
        still pending (``ready == tick + 1``) whose pages belong to ``slot``
        was created by this admission — its pages will now never be written,
        so it must not survive for a later lookup to alias garbage.  Entries
        owned by a co-admitted identical prompt (different slot) are left
        alone: their prefill still runs.  Call BEFORE ``free(slot)``."""
        held = set(self._slot_pages.get(slot, ()))
        for h in page_hashes or ():
            e = self._page_index.get(h)
            if e is not None and e.ready == tick + 1 and e.page in held:
                self._drop_page_entry(h)
        if full_hash is not None:
            fe = self._full_index.get(full_hash)
            if fe is not None and fe.ready == tick + 1 \
                    and set(fe.pages) <= held:
                self._drop_full_entry(full_hash)

    def _reserve_full_entry(self, full_hash: bytes, row: List[int],
                            bucket: int, tick: int) -> int:
        """Pin this admission's prompt pages + one prefix-cache row so the
        whole prompt can be restored later.  Returns the row or -1 when no
        row is available (all in use and nothing evictable)."""
        if self.prefix_entries == 0 or full_hash in self._full_index:
            return -1
        if not self._row_free:
            # evict the least-recently-used NON-PENDING full entry to
            # recycle its row (a pending row has a device write in flight);
            # ties in ``used`` go to the oldest entry, not to the heap's
            # hash order, and the scan covers ``prefix_entries`` rows
            cand = [kv for kv in self._full_index.items()
                    if kv[1].ready <= tick]
            if not cand:
                return -1
            lru = min(cand, key=lambda kv: kv[1].used)
            self._drop_full_entry(lru[0])
            self.stats["evictions"] += 1
        r = self._row_free.pop()
        pages = row[: self.pages_needed(bucket)]
        for p in pages:
            self._refs[p] += 1
        self._full_index[full_hash] = _FullEntry(
            row=r, pages=list(pages), bucket=bucket, ready=tick + 1,
            used=tick)
        self._push(1, full_hash, self._full_index[full_hash])
        return r

    def write_block(self) -> np.ndarray:
        """Block table for the DECODE WRITE path: pages referenced by more
        than one slot are masked to the null page, so an (invariant-breaking)
        append into a shared page drops instead of corrupting a co-resident
        request.  Host admission guarantees the written page is exclusive
        (COW), making this pure defense in depth."""
        shared = self._slot_refs[self.block] > 1
        return np.where(shared, 0, self.block).astype(np.int32)

    def check_invariants(self) -> None:
        """Debug/test hook: refcount conservation — every page's refcount
        equals its slot references + index retentions, free pages carry no
        references, and live + free pages partition the pool.  An int8 pool
        also checks its scale rows: float32, one row per physical page and
        kv head beside each int8 page pool, so every move of a page moves
        its scale row."""
        pages = page_tensors(self.buffers)
        if len(pages) == 4:               # int8: the pools, then their scales
            for pool, scale in zip(pages[:2], pages[2:]):
                assert pool.dtype == torch.int8, \
                    f"quantized pool must be int8, got {pool.dtype}"
                assert scale.dtype == torch.float32, \
                    f"scale rows must be float32, got {scale.dtype}"
                # pools (..., P, page, K, Dh), scales (..., P, K)
                assert scale.shape[-2] == self.num_pages, \
                    f"{scale.shape[-2]} scale rows for {self.num_pages} pages"
                assert scale.shape[:-2] == pool.shape[:-4] and \
                    scale.shape[-1] == pool.shape[-2], \
                    f"scale shape {tuple(scale.shape)} does not match pool " \
                    f"shape {tuple(pool.shape)}"
        else:
            assert len(pages) in (0, 2), "one scale tensor without the other"
        refs = np.zeros((self.num_pages,), np.int32)
        slot_refs = np.zeros((self.num_pages,), np.int32)
        for pages in self._slot_pages.values():
            for p in pages:
                refs[p] += 1
                slot_refs[p] += 1
        for e in self._page_index.values():
            refs[e.page] += 1
        for e in self._full_index.values():
            for p in e.pages:
                refs[p] += 1
        assert (refs == self._refs).all(), "refcount conservation violated"
        assert (slot_refs == self._slot_refs).all(), \
            "slot refcount conservation violated"
        free = set(self._free)
        assert len(free) == len(self._free), "free list holds duplicates"
        assert 0 not in free, "null page freed"
        assert self._refs[0] == 0, "null page referenced"
        live = {p for p in range(self.num_pages) if self._refs[p] > 0}
        assert not (free & live), "page free AND referenced"
        assert len(free) + len(live) == self.num_pages - 1, "pages leaked"
        for slot in range(self.num_slots):
            row = set(self.block[slot][self.block[slot] > 0].tolist())
            assert row <= set(self._slot_pages.get(slot, [])), \
                f"slot {slot} block row references unheld pages"
        rows = [e.row for e in self._full_index.values()]
        assert len(set(rows)) == len(rows), "prefix-cache row double-booked"
        assert not (set(rows) & set(self._row_free)), \
            "prefix-cache row free AND in use"
        if self.prefix_entries:
            assert len(rows) + len(self._row_free) == self.prefix_entries, \
                "prefix-cache rows leaked"
