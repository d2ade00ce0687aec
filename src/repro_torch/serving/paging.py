"""Paged KV cache around the registry's cache trees (the port of
``repro.serving.paging`` for attention-family stacks).

The physical layout lives in ``models/layers.py`` (``init_paged_kv_cache``:
a shared (num_pages, page_size, KV, hd) pool and per-sequence block
tables). This module owns what surrounds it:

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
  leaks its previous owner's entries into attention.

Prefix sharing (``PrefixIndex``, ``fork_pages``), SWA page recycling
(``unmap_pages``), swap-out of pages to host files and recurrent block
state are not ported (ROADMAP.md queue A): :func:`init_paged_cache` raises
for block kinds other than "attn".
"""
from __future__ import annotations

import heapq
from typing import Dict, Iterator, List, Sequence, Set, Tuple

import numpy as np
import torch

from repro_torch.models import layers, registry

_POOL_LEAVES = ("k_pages", "v_pages", "k_scale", "v_scale", "kv_pos")
_ATTN_KINDS = ("attn",)


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
def init_paged_cache(cfg, max_seqs: int, num_pages: int, page_size: int,
                     pages_per_seq: int, dtype=torch.bfloat16,
                     kv_bits: int = 32, device="cpu") -> Dict:
    """Paged counterpart of ``registry.init_cache``: the same tree
    structure, with a page pool and block table per attention layer (the
    layers of a unit position stacked along a leading depth axis, as in
    the JAX package; every layer holds the same block-table rows)."""
    unit, n_full, rem = registry.segments(cfg)
    kinds = (set(unit) if n_full else set()) | set(rem)
    if not kinds <= set(_ATTN_KINDS):
        raise NotImplementedError(
            f"paged serving of block kinds {sorted(kinds - set(_ATTN_KINDS))}"
            f" is not ported (ROADMAP.md queue A); it serves {_ATTN_KINDS}")

    def one():
        return layers.init_paged_kv_cache(
            max_seqs, num_pages, page_size, pages_per_seq, cfg.num_kv_heads,
            cfg.resolved_head_dim, dtype, kv_bits=kv_bits, device=device)

    caches: Dict = {"units": {}, "rem": {}}
    if n_full > 0:
        for i, _ in enumerate(unit):
            reps = [one() for _ in range(n_full)]
            caches["units"][f"p{i}"] = {k: torch.stack([r[k] for r in reps])
                                        for k in reps[0]}
    for i, _ in enumerate(rem):
        caches["rem"][f"p{i}"] = one()
    return caches


def _block_caches(cache) -> Iterator[Tuple[dict, bool]]:
    """(leaf dict, stacked) for every block's cache; stacked leaves carry
    the leading depth axis."""
    for c in cache["units"].values():
        yield c, True
    for c in cache["rem"].values():
        yield c, False


def _device(cache) -> torch.device:
    return next(_block_caches(cache))[0]["block_tables"].device


def _invalidate(c: dict, pages) -> None:
    """kv_pos = -1 on every listed page (negative ids are skipped)."""
    pages = [int(p) for p in pages if p >= 0]
    if pages:
        idx = torch.tensor(pages, dtype=torch.long,
                           device=c["kv_pos"].device)
        c["kv_pos"][..., idx, :] = -1


def admit_slot(cache, slot: int, row, fresh_row=None):
    """Bind sequence slot ``slot`` to the pages of ``row`` ((pages_per_seq,)
    int32, -1 = unmapped tail) and invalidate ``kv_pos`` on the freshly
    bound pages (``fresh_row``, by default ``row``). In place; returns the
    cache."""
    dev = _device(cache)
    row_t = torch.as_tensor(np.asarray(row, np.int32), device=dev)
    fresh = np.asarray(row if fresh_row is None else fresh_row)
    for c, _ in _block_caches(cache):
        c["block_tables"][..., slot, :] = row_t
        _invalidate(c, fresh)
    return cache


def release_slot(cache, slot: int, row):
    """Unbind slot ``slot`` (its block-table row becomes -1) and
    invalidate the recycled pages in ``row``. In place."""
    for c, _ in _block_caches(cache):
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
    slot's block-table row), the block tables are viewed at that slot."""
    out: Dict = {"units": {}, "rem": {}}
    for part in ("units", "rem"):
        for key, c in cache[part].items():
            d = dict(c)
            d["block_tables"] = c["block_tables"][..., slot:slot + 1, :]
            out[part][key] = d
    return out


def merge_slot(cache, updated_slice, slot: int):
    """Inverse of :func:`slice_slot` after a model step: pool leaves and
    the slot's block-table row take the slice's values (a no-op when the
    step wrote in place, as the ported layers do)."""
    for part in ("units", "rem"):
        for key, c in cache[part].items():
            new = updated_slice[part][key]
            for name, x in c.items():
                dst = (x[..., slot:slot + 1, :] if name == "block_tables"
                       else x)
                if new[name].data_ptr() != dst.data_ptr():
                    dst.copy_(new[name])
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
