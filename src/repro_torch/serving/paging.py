"""Paged KV cache around the registry's cache trees (the port of
``repro.serving.paging`` for attention and xLSTM stacks).

The physical layout lives in ``models/layers.py`` (``init_paged_kv_cache``:
a shared (num_pages, page_size, KV, hd) pool and per-sequence block
tables). Recurrent blocks (mLSTM, sLSTM) keep their fixed-size state
indexed by sequence slot, one trivial "page" per sequence, as in the JAX
package. Every helper sorts a cache leaf as the JAX package's leaf
taxonomy does: a **pool** leaf (``k_pages``, ``v_pages``, their scales,
``kv_pos``), a **block table**, or a **per-sequence** leaf (recurrent
state, slot on the batch axis). This module owns:

* :class:`PagePool`, the host-side allocator: lowest-id-first allocation,
  so a replayed run makes the same placements; ``defrag()``
  compacts live pages and returns the permutation the device applies with
  :func:`apply_page_remap`;
* :func:`init_paged_cache`, a paged cache in the structure of
  ``registry.init_cache`` (a leading depth axis on the unit positions);
* the device updaters :func:`admit_slot`, :func:`release_slot`,
  :func:`map_pages` and :func:`apply_page_remap`. They update the cache
  **in place** (the JAX package returns new arrays) and invalidate
  ``kv_pos`` on every (re)allocated or freed page, so a recycled page never
  leaks its previous owner's entries into attention. Admission zeroes the
  slot's recurrent state, the stabilizer ``m`` too, as the JAX package
  does (a fresh contiguous cache starts ``m`` at -1e30 instead; ROADMAP C
  notes where the two part).

Prefix sharing (``PrefixIndex``, ``fork_pages``), SWA page recycling
(``unmap_pages``) and swap-out of pages and slot state to host files are
not ported (ROADMAP.md queue A): :func:`init_paged_cache` raises for block
kinds other than "attn", "mlstm" and "slstm".
"""
from __future__ import annotations

import heapq
from typing import Dict, Iterator, List, Sequence, Set, Tuple

import numpy as np
import torch

from repro_torch.models import blocks, layers, registry

_POOL_LEAVES = ("k_pages", "v_pages", "k_scale", "v_scale", "kv_pos")
_ATTN_KINDS = ("attn",)
_RECURRENT_KINDS = ("mlstm", "slstm")


def pages_needed(total_len: int, page_size: int) -> int:
    return -(-int(total_len) // int(page_size))


# ------------------------------------------------------------- allocator --
class PageAllocError(RuntimeError):
    """Raised when an allocation exceeds the free-page budget."""


class PagePool:
    """Host-side page allocator with deterministic placement: free pages
    sit in a min-heap, so every allocation takes the lowest free ids and
    two runs over the same request stream build the same block tables.
    (The JAX package's refcounts serve prefix sharing, not ported: here a
    page has one owner.)"""

    def __init__(self, num_pages: int):
        self.num_pages = int(num_pages)
        self._free: List[int] = list(range(self.num_pages))
        heapq.heapify(self._free)
        self._live: Set[int] = set()

    @property
    def free_count(self) -> int:
        return len(self._free)

    @property
    def in_use(self) -> int:
        return len(self._live)

    def can_alloc(self, n: int) -> bool:
        return len(self._free) >= n

    def alloc(self, n: int) -> List[int]:
        if n > len(self._free):
            raise PageAllocError(
                f"requested {n} pages, {len(self._free)} free")
        ids = [heapq.heappop(self._free) for _ in range(n)]
        self._live.update(ids)
        return ids

    def free(self, ids: Sequence[int]) -> List[int]:
        """Return pages to the pool; returns them (the pages the caller
        must invalidate on the device)."""
        recycled: List[int] = []
        for i in ids:
            i = int(i)
            if i not in self._live:
                raise PageAllocError(f"double free of page {i}")
            self._live.remove(i)
            heapq.heappush(self._free, i)
            recycled.append(i)
        return recycled

    def defrag(self) -> np.ndarray:
        """Compact live pages to the lowest ids. Returns ``old_to_new``
        (num_pages,) int32, a permutation: live pages keep their relative
        order, free pages fill the tail. The caller applies it to the
        device cache (:func:`apply_page_remap`) and to its own page
        lists."""
        live = sorted(self._live)
        old_to_new = np.full((self.num_pages,), -1, np.int32)
        for new, old in enumerate(live):
            old_to_new[old] = new
        nxt = len(live)
        for old in range(self.num_pages):
            if old_to_new[old] < 0:
                old_to_new[old] = nxt
                nxt += 1
        self._live = set(range(len(live)))
        self._free = list(range(len(live), self.num_pages))
        heapq.heapify(self._free)
        return old_to_new


# ------------------------------------------------------- cache structure --
def make_paged_block_cache(kind: str, cfg, max_seqs: int, num_pages: int,
                           page_size: int, pages_per_seq: int,
                           dtype=torch.bfloat16, kv_bits: int = 32,
                           device="cpu") -> Dict:
    """Paged decode state of one block: the shared page pool and block
    tables for attention; the slot-indexed recurrent state (never
    quantized: it is O(1) per sequence) for mLSTM and sLSTM."""
    if kind in _ATTN_KINDS:
        return layers.init_paged_kv_cache(
            max_seqs, num_pages, page_size, pages_per_seq, cfg.num_kv_heads,
            cfg.resolved_head_dim, dtype, kv_bits=kv_bits, device=device)
    if kind in _RECURRENT_KINDS:
        return blocks.make_cache(kind, cfg, max_seqs, page_size, dtype,
                                 device)
    raise NotImplementedError(
        f"paged serving of block kind {kind!r} is not ported (ROADMAP.md "
        f"queue A); it serves {_ATTN_KINDS + _RECURRENT_KINDS}")


def init_paged_cache(cfg, max_seqs: int, num_pages: int, page_size: int,
                     pages_per_seq: int, dtype=torch.bfloat16,
                     kv_bits: int = 32, device="cpu") -> Dict:
    """Paged counterpart of ``registry.init_cache``: the same tree
    structure, the layers of a unit position stacked along a leading depth
    axis, as in the JAX package (every attention layer holds the same
    block-table rows)."""
    unit, n_full, rem = registry.segments(cfg)

    def one(kind):
        return make_paged_block_cache(kind, cfg, max_seqs, num_pages,
                                      page_size, pages_per_seq, dtype,
                                      kv_bits=kv_bits, device=device)

    caches: Dict = {"units": {}, "rem": {}}
    if n_full > 0:
        for i, kind in enumerate(unit):
            reps = [one(kind) for _ in range(n_full)]
            caches["units"][f"p{i}"] = {k: torch.stack([r[k] for r in reps])
                                        for k in reps[0]}
    for i, kind in enumerate(rem):
        caches["rem"][f"p{i}"] = one(kind)
    return caches


def _block_caches(cache) -> Iterator[Tuple[dict, bool]]:
    """(leaf dict, stacked) for every block's cache; stacked leaves carry
    the leading depth axis."""
    for c in cache["units"].values():
        yield c, True
    for c in cache["rem"].values():
        yield c, False


def _seq_leaves(c: dict) -> List[str]:
    """The per-sequence (recurrent state) leaves of one block's cache."""
    return [k for k in c if k not in _POOL_LEAVES and k != "block_tables"]


def _slot_view(x: torch.Tensor, stacked: bool, slot: int) -> torch.Tensor:
    """Slot ``slot``'s row of a block table or per-sequence leaf, as a
    batch-1 view (the batch axis follows the depth axis where stacked)."""
    return x.narrow(1 if stacked else 0, slot, 1)


def _device(cache) -> torch.device:
    c, _ = next(_block_caches(cache))
    return next(iter(c.values())).device


def _invalidate(c: dict, pages) -> None:
    """kv_pos = -1 on every listed page (negative ids are skipped); a
    recurrent block has no pool and nothing to invalidate."""
    pages = [int(p) for p in pages if p >= 0]
    if pages and "kv_pos" in c:
        idx = torch.tensor(pages, dtype=torch.long,
                           device=c["kv_pos"].device)
        c["kv_pos"][..., idx, :] = -1


def admit_slot(cache, slot: int, row, fresh_row=None):
    """Bind sequence slot ``slot`` to the pages of ``row`` ((pages_per_seq,)
    int32, -1 = unmapped tail), invalidate ``kv_pos`` on the freshly bound
    pages (``fresh_row``, by default ``row``) and zero the slot's recurrent
    state, ``m`` included, as the JAX package's ``admit_slot`` does. In
    place; returns the cache."""
    dev = _device(cache)
    row_t = torch.as_tensor(np.asarray(row, np.int32), device=dev)
    fresh = np.asarray(row if fresh_row is None else fresh_row)
    for c, stacked in _block_caches(cache):
        if "block_tables" in c:
            c["block_tables"][..., slot, :] = row_t
            _invalidate(c, fresh)
        for name in _seq_leaves(c):
            _slot_view(c[name], stacked, slot).zero_()
    return cache


def release_slot(cache, slot: int, row):
    """Unbind slot ``slot`` (its block-table row becomes -1) and
    invalidate the recycled pages in ``row``. In place; recurrent state is
    left as it is (the next admission zeroes it)."""
    for c, _ in _block_caches(cache):
        if "block_tables" in c:
            c["block_tables"][..., slot, :] = -1
            _invalidate(c, np.asarray(row))
    return cache


def map_pages(cache, slot: int, logicals, pages):
    """Bind physical ``pages`` at logical indices ``logicals`` of slot
    ``slot``'s row and invalidate them. In place."""
    dev = _device(cache)
    li = torch.as_tensor(np.asarray(logicals, np.int64), device=dev)
    pg = torch.as_tensor(np.asarray(pages, np.int32), device=dev)
    for c, _ in _block_caches(cache):
        if "block_tables" in c:
            c["block_tables"][..., slot, li] = pg
            _invalidate(c, np.asarray(pages))
    return cache


def apply_page_remap(cache, old_to_new, new_to_old):
    """Apply a :meth:`PagePool.defrag` permutation on the device: page
    ``o`` of every pool moves to ``old_to_new[o]`` and every mapped
    block-table entry follows. Content-preserving. In place."""
    dev = _device(cache)
    o2n = torch.as_tensor(np.asarray(old_to_new, np.int32), device=dev)
    n2o = torch.as_tensor(np.asarray(new_to_old, np.int64), device=dev)
    for c, stacked in _block_caches(cache):
        if "block_tables" not in c:
            continue
        for name in _POOL_LEAVES:
            if name in c:
                x = c[name]
                x.copy_(x.index_select(1 if stacked else 0, n2o))
        bt = c["block_tables"]
        bt.copy_(torch.where(bt >= 0, o2n[torch.clamp(bt, 0).long()], -1))
    return cache


def slice_slot(cache, slot: int):
    """The paged cache as a batch-1 cache of sequence ``slot``: the pools
    pass through whole (a prefill chunk writes into them through the
    slot's block-table row); the block tables and recurrent state are
    views of that slot's row, so a step that writes them in place writes
    the slot."""
    out: Dict = {"units": {}, "rem": {}}
    for part, stacked in (("units", True), ("rem", False)):
        for key, c in cache[part].items():
            out[part][key] = {
                name: (x if name in _POOL_LEAVES
                       else _slot_view(x, stacked, slot))
                for name, x in c.items()}
    return out


def merge_slot(cache, updated_slice, slot: int):
    """Inverse of :func:`slice_slot` after a model step: pool leaves take
    the slice's values and the slot's rows of the block tables and
    recurrent state take the slice's rows. A leaf the step wrote in place
    (as the ported layers do) is the slice's own view and is not
    copied."""
    for part, stacked in (("units", True), ("rem", False)):
        for key, c in cache[part].items():
            new = updated_slice[part][key]
            for name, x in c.items():
                dst = x if name in _POOL_LEAVES else _slot_view(x, stacked,
                                                                slot)
                src = new[name]
                if not (src.data_ptr() == dst.data_ptr()
                        and src.stride() == dst.stride()
                        and src.shape == dst.shape):
                    dst.copy_(src)
    return cache


def build_block_table_row(pages: Sequence[int], pages_per_seq: int
                          ) -> np.ndarray:
    row = np.full((pages_per_seq,), -1, np.int32)
    row[: len(pages)] = np.asarray(pages, np.int32)
    return row


# ------------------------------------------------------------- metrics --
def cache_page_bytes(cache) -> int:
    """Bytes held by the page pools: K/V payload plus, for code pools,
    the ranges (``kv_pos`` and block tables are bookkeeping and not
    counted)."""
    total = 0
    for c, _ in _block_caches(cache):
        for name in ("k_pages", "v_pages", "k_scale", "v_scale"):
            if name in c:
                total += c[name].numel() * c[name].element_size()
    return total
