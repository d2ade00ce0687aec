"""Paged KV cache around the registry's cache trees (the port of
``repro.serving.paging`` for attention, MoE, xLSTM and Mamba2 stacks).

The physical layout lives in ``models/layers.py`` (``init_paged_kv_cache``:
a shared (num_pages, page_size, KV, hd) pool and per-sequence block
tables). Recurrent blocks (mLSTM, sLSTM, Mamba2) keep their fixed-size
state indexed by sequence slot, one trivial "page" per sequence, as in the
JAX package (Mamba2's float32 SSD state and its conv tail in the cache
dtype). Every helper sorts a cache leaf as the JAX package's leaf
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
  slot's recurrent state (Mamba2's state and conv tail; xLSTM's, the
  stabilizer ``m`` too), as the JAX package does (a fresh contiguous cache starts ``m`` at -1e30 instead; ROADMAP C
  notes where the two part).

Production load (the scheduler's ``share_prefix`` and ``preempt``):

* pages are **refcounted**: ``alloc`` hands out pages at count 1,
  ``retain`` lets another block table map a live page, ``free`` drops one
  reference and returns only the pages whose count reached 0 (only those
  may be invalidated on the device);
* :class:`PrefixIndex` maps the chained sha256 of each full page's tokens
  to the physical pages holding that content (the JAX package's hash
  bytes exactly);
* :func:`fork_pages` copies a shared page into a fresh one, every pool
  leaf bit for bit, for a copy-on-write;
* :func:`extract_pages` / :func:`insert_pages` and
  :func:`extract_seq_state` / :func:`insert_seq_state` move a sequence's
  pages and recurrent slot state to host numpy and back (swap
  preemption), keyed by the cache tree's keystr paths.

* :func:`unmap_pages` drops the pages of a sequence that fell behind its
  sliding window (SWA page recycling).

Attention kinds ("attn", "swa", "moe", "shared_attn": ``blocks.ATTN_KINDS``)
get the shared page pool: the window is enforced by the attention mask, not
the pool, as in the JAX package. A "shared_attn" cache is per occurrence
(its weights are shared, its K/V are not). An encoder-decoder's caches
(the "xattn" kind's self K/V and cross K/V) are not paged, as in the JAX
package: :func:`make_paged_block_cache` and :func:`init_paged_cache` raise
for them, and whisper is served by the lockstep engine.
"""
from __future__ import annotations

import hashlib
import heapq
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import tree as T
from repro_torch.models import blocks, layers, registry

_POOL_LEAVES = ("k_pages", "v_pages", "k_scale", "v_scale", "kv_pos")
_ATTN_KINDS = blocks.ATTN_KINDS


def pages_needed(total_len: int, page_size: int) -> int:
    return -(-int(total_len) // int(page_size))


# ------------------------------------------------------------- allocator --
class PageAllocError(RuntimeError):
    """Raised when an allocation exceeds the free-page budget."""


class PagePool:
    """Host-side page allocator with deterministic placement: free pages
    sit in a min-heap, so every allocation takes the lowest free ids and
    two runs over the same request stream build the same block tables.

    Pages carry refcounts for copy-on-write prefix sharing: ``alloc``
    returns pages at count 1, ``retain`` adds a reference to a live page
    that another block table maps, and ``free`` drops one; a page returns
    to the heap (and to the caller, for ``kv_pos`` invalidation) only when
    its count reaches 0."""

    def __init__(self, num_pages: int):
        self.num_pages = int(num_pages)
        self._free: List[int] = list(range(self.num_pages))
        heapq.heapify(self._free)
        self._refs: Dict[int, int] = {}

    @property
    def free_count(self) -> int:
        return len(self._free)

    @property
    def in_use(self) -> int:
        """Physical pages with a reference (not the sum of the counts)."""
        return len(self._refs)

    def can_alloc(self, n: int) -> bool:
        return len(self._free) >= n

    def alloc(self, n: int) -> List[int]:
        if n > len(self._free):
            raise PageAllocError(
                f"requested {n} pages, {len(self._free)} free")
        ids = [heapq.heappop(self._free) for _ in range(n)]
        for i in ids:
            self._refs[i] = 1
        return ids

    def retain(self, ids: Sequence[int]) -> None:
        """Add a reference to live pages (another block table maps
        them)."""
        for i in ids:
            i = int(i)
            if i not in self._refs:
                raise PageAllocError(f"retain of free page {i}")
            self._refs[i] += 1

    def refcount(self, page: int) -> int:
        return self._refs.get(int(page), 0)

    def ref_stats(self) -> Tuple[int, int]:
        """(sum of the refcounts, pages with a count above 1)."""
        total = shared = 0
        for v in self._refs.values():
            total += v
            shared += v > 1
        return total, shared

    def free(self, ids: Sequence[int]) -> List[int]:
        """Drop one reference per page; returns the pages whose count
        reached 0 and were recycled (the only ones the caller may
        invalidate on the device: other owners still read the rest)."""
        recycled: List[int] = []
        for i in ids:
            i = int(i)
            rc = self._refs.get(i)
            if rc is None:
                raise PageAllocError(f"double free of page {i}")
            if rc == 1:
                del self._refs[i]
                heapq.heappush(self._free, i)
                recycled.append(i)
            else:
                self._refs[i] = rc - 1
        return recycled

    def defrag(self) -> np.ndarray:
        """Compact live pages to the lowest ids. Returns ``old_to_new``
        (num_pages,) int32, a permutation: live pages keep their relative
        order, free pages fill the tail. Refcounts move with their page.
        The caller applies it to the device cache (:func:`apply_page_remap`)
        and to its own page lists and :class:`PrefixIndex`."""
        live = sorted(self._refs)
        old_to_new = np.full((self.num_pages,), -1, np.int32)
        for new, old in enumerate(live):
            old_to_new[old] = new
        nxt = len(live)
        for old in range(self.num_pages):
            if old_to_new[old] < 0:
                old_to_new[old] = nxt
                nxt += 1
        self._refs = {int(old_to_new[p]): rc for p, rc in self._refs.items()}
        self._free = list(range(len(live), self.num_pages))
        heapq.heapify(self._free)
        return old_to_new


# ---------------------------------------------------------- prefix index --
class PrefixIndex:
    """Content index over full pages for copy-on-write prefix sharing.

    A page's identity is the chained hash ``h_i = sha256(h_{i-1} ||
    tokens[i*ps:(i+1)*ps])`` (tokens as int32 bytes) from a fixed root, so
    the same tokens at another depth hash differently and a hit means the
    whole prefix up to that page matches. A hash maps to the set of
    physical pages holding that content (requests admitted in one tick
    materialise duplicates before any is indexed); ``lookup`` returns the
    lowest live one. A page indexes at most one hash; ``drop_page`` and
    ``remap`` follow recycling and defrag. Only full, completely written
    pages are registered."""

    ROOT = b"paged-kv-prefix-root"

    def __init__(self, page_size: int):
        self.page_size = int(page_size)
        self._by_hash: Dict[bytes, set] = {}
        self._by_page: Dict[int, bytes] = {}

    def __len__(self) -> int:
        return len(self._by_hash)

    @staticmethod
    def chain(parent: bytes, tokens) -> bytes:
        return hashlib.sha256(
            parent + np.asarray(tokens, np.int32).tobytes()).digest()

    def hash_chain(self, tokens) -> List[bytes]:
        """The chained hash of every full page of ``tokens``."""
        toks = np.asarray(tokens, np.int32)
        ps, h, out = self.page_size, self.ROOT, []
        for i in range(len(toks) // ps):
            h = self.chain(h, toks[i * ps:(i + 1) * ps])
            out.append(h)
        return out

    def lookup(self, h: bytes) -> Optional[int]:
        pages = self._by_hash.get(h)
        return min(pages) if pages else None

    def register(self, h: bytes, page: int) -> None:
        page = int(page)
        if page in self._by_page:
            return
        self._by_hash.setdefault(h, set()).add(page)
        self._by_page[page] = h

    def drop_page(self, page: int) -> None:
        h = self._by_page.pop(int(page), None)
        if h is not None:
            pages = self._by_hash[h]
            pages.discard(int(page))
            if not pages:
                del self._by_hash[h]

    def remap(self, old_to_new) -> None:
        """Follow a :meth:`PagePool.defrag` permutation."""
        o2n = np.asarray(old_to_new)
        self._by_page = {int(o2n[p]): h for p, h in self._by_page.items()}
        self._by_hash = {}
        for p, h in self._by_page.items():
            self._by_hash.setdefault(h, set()).add(p)


# ------------------------------------------------------- cache structure --
def make_paged_block_cache(kind: str, cfg, max_seqs: int, num_pages: int,
                           page_size: int, pages_per_seq: int,
                           dtype=torch.bfloat16, kv_bits: int = 32,
                           device="cpu") -> Dict:
    """Paged decode state of one block: the shared page pool and block
    tables for attention; the slot-indexed recurrent state (never
    quantized: it is O(1) per sequence) for mLSTM, sLSTM and Mamba2."""
    if kind in _ATTN_KINDS:
        return layers.init_paged_kv_cache(
            max_seqs, num_pages, page_size, pages_per_seq, cfg.num_kv_heads,
            cfg.resolved_head_dim, dtype, kv_bits=kv_bits, device=device)
    if kind == "xattn":
        raise NotImplementedError(
            "encoder-decoder caches are not paged; serve whisper-small "
            "through the contiguous path (the lockstep engine)")
    return blocks.make_cache(kind, cfg, max_seqs, page_size, dtype, device)


def init_paged_cache(cfg, max_seqs: int, num_pages: int, page_size: int,
                     pages_per_seq: int, dtype=torch.bfloat16,
                     kv_bits: int = 32, device="cpu") -> Dict:
    """Paged counterpart of ``registry.init_cache``: the same tree
    structure, the layers of a unit position stacked along a leading depth
    axis, as in the JAX package (every attention layer holds the same
    block-table rows)."""
    if cfg.is_encoder_decoder:
        raise NotImplementedError(
            "encoder-decoder caches are not paged (serve through the "
            "lockstep engine)")
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


def unmap_pages(cache, slot: int, logicals, recycled_row):
    """Drop logical pages ``logicals`` from slot ``slot``'s block-table row
    (SWA page recycling: pages wholly behind the attention window are never
    read again). Only the pages of ``recycled_row`` (those whose refcount
    reached 0; -1 entries are skipped) get ``kv_pos`` invalidated: a page
    another sequence still maps keeps its entries. In place."""
    dev = _device(cache)
    li = torch.as_tensor(np.asarray(logicals, np.int64), device=dev)
    for c, _ in _block_caches(cache):
        if "block_tables" in c:
            c["block_tables"][..., slot, li] = -1
            _invalidate(c, np.asarray(recycled_row))
    return cache


def fork_pages(cache, slot: int, logicals, srcs, dsts, write_pos: int):
    """Copy-on-write fork: copy physical pages ``srcs`` into ``dsts`` in
    every pool leaf (K/V, or codes and their ranges: the copy is the donor
    bit for bit), with the copies' ``kv_pos`` masked to -1 at positions >=
    ``write_pos`` (the donor may have written its own tokens past the
    shared point), and rebind only slot ``slot``'s row at ``logicals``.
    In place."""
    dev = _device(cache)
    src = torch.as_tensor(np.asarray(srcs, np.int64), device=dev)
    dst = torch.as_tensor(np.asarray(dsts, np.int64), device=dev)
    li = torch.as_tensor(np.asarray(logicals, np.int64), device=dev)
    for c, stacked in _block_caches(cache):
        if "block_tables" not in c:
            continue
        axis = 1 if stacked else 0
        for name in _POOL_LEAVES:
            if name in c:
                x = c[name]
                slab = x.index_select(axis, src)
                if name == "kv_pos":
                    slab = torch.where(slab < int(write_pos), slab, -1)
                x.index_copy_(axis, dst, slab)
        c["block_tables"][..., slot, li] = dst.to(torch.int32)
    return cache


# -------------------------------------------------- preemption swap I/O --
def _leaf_items(cache):
    """(keystr path, leaf dict, name, stacked) for every cache leaf, the
    path in the JAX package's keystr form (``['units']['p0']['k_pages']``)."""
    for part, stacked in (("units", True), ("rem", False)):
        for key, c in cache[part].items():
            for name in c:
                yield T.keystr((part, key, name)), c, name, stacked


def _to_host(x: torch.Tensor) -> np.ndarray:
    """A host copy numpy can save: bfloat16 (which numpy lacks) as its raw
    bits, uint16, as the JAX package's ``_npz_safe`` stores it. Always a
    copy: on the CPU ``.cpu()`` of a slot's view would alias the cache,
    and the next step's in-place writes would show through."""
    x = x.detach().to("cpu", copy=True)
    if x.dtype == torch.bfloat16:
        return x.view(torch.int16).numpy().view(np.uint16)
    return x.numpy()


def _from_host(a: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    if like.dtype == torch.bfloat16 and a.dtype == np.uint16:
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.int16))
        return t.view(torch.bfloat16).to(like.device)
    return torch.as_tensor(np.ascontiguousarray(a), dtype=like.dtype,
                           device=like.device)


def extract_pages(cache, pages) -> Dict[str, np.ndarray]:
    """The pool slabs (K/V or codes and ranges, ``kv_pos``) of physical
    ``pages`` on the host, keyed by leaf path: what a swap preemption
    saves."""
    idx = torch.as_tensor(np.asarray(pages, np.int64), device=_device(cache))
    return {path: _to_host(c[name].index_select(1 if stacked else 0, idx))
            for path, c, name, stacked in _leaf_items(cache)
            if name in _POOL_LEAVES}


def insert_pages(cache, slabs: Dict[str, np.ndarray], pages):
    """Inverse of :func:`extract_pages` into ``pages`` (other physical ids
    than the extracted ones; the caller rebuilds the block tables). In
    place."""
    idx = torch.as_tensor(np.asarray(pages, np.int64), device=_device(cache))
    for path, c, name, stacked in _leaf_items(cache):
        if path in slabs:
            x = c[name]
            x.index_copy_(1 if stacked else 0, idx,
                          _from_host(slabs[path], x))
    return cache


def extract_seq_state(cache, slot: int) -> Dict[str, np.ndarray]:
    """The per-sequence (recurrent) leaves of slot ``slot`` on the host,
    keyed by leaf path (each with a batch axis of 1)."""
    return {path: _to_host(_slot_view(c[name], stacked, slot))
            for path, c, name, stacked in _leaf_items(cache)
            if name not in _POOL_LEAVES and name != "block_tables"}


def insert_seq_state(cache, state: Dict[str, np.ndarray], slot: int):
    """Inverse of :func:`extract_seq_state`, possibly into another slot.
    In place."""
    for path, c, name, stacked in _leaf_items(cache):
        if path in state:
            view = _slot_view(c[name], stacked, slot)
            view.copy_(_from_host(state[path], view))
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


def cache_bytes_per_token(cache) -> float:
    """Pool bytes per cached-token slot, summed over every layer (K + V +
    side information): the modeled bytes of attending one cached token in
    one decode step (at context C a step reads ~C times this per
    sequence), the quantity the serve-smoke ``long_context`` stage
    gates."""
    for c, _ in _block_caches(cache):
        kv_pos = c.get("kv_pos")
        if kv_pos is not None and kv_pos.dim() >= 2:
            slots = kv_pos.shape[-2] * kv_pos.shape[-1]    # num_pages * ps
            return cache_page_bytes(cache) / slots
    raise ValueError("not a paged cache (no pool-shaped kv_pos leaf)")
