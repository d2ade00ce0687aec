"""Request scheduler with continuous batching over the paged cache (the
port of ``repro.serving.scheduler`` for FIFO full-reservation admission),
for attention stacks (KV pages) and xLSTM stacks (per-slot recurrent
state, zeroed at admission).

``max_seqs`` sequence slots share one page pool; a sequence that finishes
releases its slot and pages at once, and the next request is admitted as
soon as a slot is free and the pool can hold it. Ties are broken
deterministically, so a replayed run makes the same decisions.

* **Admission**: strict FIFO with head-of-line blocking. The oldest
  waiting request is admitted iff a slot is free and the pool can reserve
  its whole footprint, ceil((prompt + max_new_tokens) / page_size) pages,
  so an admitted request always runs to completion.
* **Chunked prefill**: an admitted prompt is written in exact
  ``prefill_chunk``-token chunks (batch-1 steps against the shared pools
  through ``paging.slice_slot``); the rest, at least the last prompt
  token, rides the shared decode steps as teacher-forced tokens. Chunks
  are never padded, so recurrent state sees only real tokens; an xLSTM
  chunk runs the sLSTM cell kernel at (1, ``prefill_chunk``).
* **Decode**: one step for all slots per tick; inactive slots carry
  position -1 (their pool writes are dropped; their recurrent state moves
  and is zeroed again at the next admission, as in the JAX package). Greedy sampling is an argmax on
  the device; temperature sampling draws each slot's token with its own
  ``torch.Generator`` seeded from (seed, request id, position), so a
  request's draws do not depend on which requests share its batch.
* **Eviction** frees a finished request's pages; ``defrag_every``
  compacts live pages (content-preserving).

Not ported (ROADMAP.md queue A): prefix sharing, watermark admission with
preemption (recompute or swap), SWA page recycling, the asyncio
``AsyncServer`` and tracing. The JAX package's threefry keys cannot be
reproduced in PyTorch, so temperature sampling draws other tokens than
the JAX package's; greedy decoding is what the two are held equal on.
"""
from __future__ import annotations

import dataclasses
import os
import time
from collections import deque
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models import registry
from repro_torch.serving import paging


def _env_kv_bits() -> int:
    """Default KV-page width; REPRO_SERVE_KV_BITS overrides."""
    return int(os.environ.get("REPRO_SERVE_KV_BITS", "32"))


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported (ROADMAP.md queue A: "
                               f"serving)")


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Scheduler and paged-cache geometry. The JAX package's production-
    load policies keep their switches; any setting but the default raises,
    because they are not ported (nor are their tuning fields)."""
    max_seqs: int = 4                 # decode batch width
    page_size: int = 16               # tokens per page
    num_pages: int = 128              # shared pool size
    pages_per_seq: int = 16           # block-table width (context cap)
    prefill_chunk: int = 16           # bulk-prefill chunk length
    sample: str = "greedy"            # "greedy" | "temp"
    temperature: float = 1.0
    seed: int = 0
    defrag_every: int = 0             # 0 = never
    cache_dtype: str = "bfloat16"
    # 32 = full-precision pages; 8/4 = code pools with float32 ranges
    kv_bits: int = dataclasses.field(default_factory=_env_kv_bits)
    share_prefix: bool = False
    preempt: bool = False
    preempt_mode: str = "recompute"
    swa_recycle: bool = False

    @property
    def max_context(self) -> int:
        return self.page_size * self.pages_per_seq

    def __post_init__(self):
        if self.sample not in ("greedy", "temp"):
            raise ValueError(f"unknown sample mode {self.sample!r}")
        if self.kv_bits not in (32, 8, 4):
            raise ValueError(f"kv_bits must be 32, 8 or 4, "
                             f"got {self.kv_bits}")
        if self.preempt_mode not in ("recompute", "swap"):
            raise ValueError(f"unknown preempt_mode {self.preempt_mode!r}")
        for name, ported in (("share_prefix", not self.share_prefix),
                             ("preempt", not self.preempt),
                             ("preempt_mode='swap'",
                              self.preempt_mode == "recompute"),
                             ("swa_recycle", not self.swa_recycle)):
            if not ported:
                raise _not_ported(name)


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray                # (plen,) int32
    max_new_tokens: int


@dataclasses.dataclass
class _Slot:
    req: Request
    pages: Dict[int, int]             # logical page -> physical page
    fed: int                          # tokens already written to the cache
    bulk_end: int                     # prefill-chunk target (rest decodes)
    generated: List[int] = dataclasses.field(default_factory=list)

    @property
    def known(self) -> int:
        """Tokens whose values are known (prompt + already generated)."""
        return len(self.req.prompt) + len(self.generated)

    def token_at(self, f: int) -> int:
        plen = len(self.req.prompt)
        return (int(self.req.prompt[f]) if f < plen
                else int(self.generated[f - plen]))


def sample_tokens(logits: torch.Tensor, mode: str, temperature: float,
                  seeds: Optional[Sequence[int]] = None) -> torch.Tensor:
    """(B, V) logits -> (B,) int64 tokens on the logits' device. Greedy is
    the argmax (the first maximal index, as ``jnp.argmax``); "temp" draws
    row i from softmax(logits / T) with a ``torch.Generator`` seeded with
    ``seeds[i]``."""
    if mode == "greedy":
        return torch.argmax(logits, dim=-1)
    probs = torch.softmax(logits.to(torch.float32) / float(temperature),
                          dim=-1)
    out = []
    for row, seed in zip(probs, seeds):
        gen = torch.Generator(device=logits.device).manual_seed(int(seed))
        out.append(torch.multinomial(row, 1, generator=gen))
    return torch.cat(out)


def draw_seed(seed: int, *stream: int) -> int:
    """A 63-bit generator seed from the run's seed and a stream label
    (request id and position), the same on every run and device."""
    return int(np.random.SeedSequence([seed, *stream]).generate_state(
        1, np.uint64)[0] >> np.uint64(1))


class Scheduler:
    """Synchronous continuous-batching core. Drive with ``submit()`` and
    ``step()``, or ``run()`` to drain; results land in ``finished[rid]``
    as (max_new_tokens,) int32 arrays. ``device=None`` is the CUDA card.
    With ``record_top`` = k > 0 each request's k largest logits and their
    token ids at every generated position land in ``top[rid]`` (one more
    small reduction per tick; for comparing two engines' greedy
    streams)."""

    def __init__(self, model_cfg, params, cfg: ServeConfig, device=None,
                 record_top: int = 0):
        self.model_cfg = model_cfg
        self.cfg = cfg
        self.params = params
        self.device = resolve_device(device)
        dtype = (torch.bfloat16 if cfg.cache_dtype == "bfloat16"
                 else torch.float32)
        self.cache = paging.init_paged_cache(
            model_cfg, cfg.max_seqs, cfg.num_pages, cfg.page_size,
            cfg.pages_per_seq, dtype, kv_bits=cfg.kv_bits,
            device=self.device)
        self.pool = paging.PagePool(cfg.num_pages)
        self.slots: List[Optional[_Slot]] = [None] * cfg.max_seqs
        self.waiting: deque = deque()
        self.finished: Dict[int, np.ndarray] = {}
        self._next_rid = 0
        self.steps = 0
        self.decode_steps = 0
        self.prefill_chunks = 0
        self.prefill_tokens = 0
        self.decode_tokens = 0
        self.peak_pages_in_use = 0
        self.pages_alloc_events = 0
        # host wall seconds of each decode tick and prefill chunk, each
        # ending in a device synchronisation
        self.decode_step_s: List[float] = []
        self.prefill_chunk_s: List[float] = []
        self.record_top = record_top
        self.top: Dict[int, List] = {}

    # ------------------------------------------------------------- intake --
    def submit(self, prompt: Sequence[int], max_new_tokens: int) -> int:
        prompt = np.asarray(prompt, np.int32)
        total = len(prompt) + max_new_tokens
        need = paging.pages_needed(total, self.cfg.page_size)
        if len(prompt) < 1 or max_new_tokens < 1:
            raise ValueError("need a non-empty prompt and max_new_tokens>=1")
        if total > self.cfg.max_context or need > self.cfg.num_pages:
            raise ValueError(
                f"request of {total} tokens exceeds the serve capacity "
                f"(max_context={self.cfg.max_context}, "
                f"num_pages={self.cfg.num_pages})")
        rid = self._next_rid
        self._next_rid += 1
        self.waiting.append(Request(rid, prompt, int(max_new_tokens)))
        return rid

    @property
    def busy(self) -> bool:
        return bool(self.waiting) or any(s is not None for s in self.slots)

    # -------------------------------------------------------------- admit --
    def _admit(self) -> int:
        """FIFO full-reservation admission (head-of-line blocking)."""
        admitted = 0
        ps, pps = self.cfg.page_size, self.cfg.pages_per_seq
        while self.waiting:
            free_slots = [i for i, s in enumerate(self.slots) if s is None]
            if not free_slots:
                return admitted
            req = self.waiting[0]
            need = paging.pages_needed(len(req.prompt) + req.max_new_tokens,
                                       ps)
            if not self.pool.can_alloc(need):
                return admitted
            self.waiting.popleft()
            slot = free_slots[0]
            pages = self.pool.alloc(need)
            self.pages_alloc_events += need
            row = paging.build_block_table_row(pages, pps)
            paging.admit_slot(self.cache, slot, row)
            chunk = self.cfg.prefill_chunk
            bulk_end = ((len(req.prompt) - 1) // chunk) * chunk
            self.slots[slot] = _Slot(req, dict(enumerate(pages)), fed=0,
                                     bulk_end=bulk_end)
            admitted += 1
        return admitted

    # ------------------------------------------------------------ prefill --
    def _prefill_chunk(self, slot: int, tokens: np.ndarray,
                       positions: np.ndarray) -> None:
        sliced = paging.slice_slot(self.cache, slot)
        registry.apply_model(
            self.params, self.model_cfg,
            {"tokens": torch.as_tensor(tokens, device=self.device),
             "positions": registry.build_positions(
                 self.model_cfg, positions).to(self.device)},
            caches=sliced)
        paging.merge_slot(self.cache, sliced, slot)

    def _bulk_prefill(self) -> int:
        chunk = self.cfg.prefill_chunk
        ran = 0
        for slot, st in enumerate(self.slots):
            if st is None:
                continue
            while st.fed < st.bulk_end:
                f0 = st.fed
                toks = np.array([st.token_at(i)
                                 for i in range(f0, f0 + chunk)],
                                np.int32)[None, :]
                pos = np.arange(f0, f0 + chunk, dtype=np.int32)[None, :]
                t0 = time.perf_counter()
                self._prefill_chunk(slot, toks, pos)
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
                self.prefill_chunk_s.append(time.perf_counter() - t0)
                self.prefill_chunks += 1
                self.prefill_tokens += chunk
                ran += 1
                st.fed += chunk
        return ran

    # ------------------------------------------------------------- decode --
    def _decode(self, tokens: np.ndarray, pos: np.ndarray,
                active: np.ndarray, seeds: List[int]):
        dev = self.device
        positions = registry.build_positions(
            self.model_cfg, np.where(active, pos, -1)[:, None]).to(dev)
        logits, _ = registry.decode_step(
            self.params, self.model_cfg,
            torch.as_tensor(tokens[:, None], device=dev), positions,
            self.cache)
        nxt = sample_tokens(logits[:, -1, :], self.cfg.sample,
                            self.cfg.temperature, seeds)
        if not self.record_top:
            return nxt.cpu().numpy(), None       # waits for the device
        top = torch.topk(logits[:, -1, :].float(), self.record_top, dim=-1)
        return nxt.cpu().numpy(), (top.values.cpu().numpy(),
                                   top.indices.cpu().numpy())

    def _decode_tick(self) -> int:
        b = self.cfg.max_seqs
        tokens = np.zeros((b,), np.int32)
        pos = np.zeros((b,), np.int32)
        active = np.zeros((b,), bool)
        seeds = [0] * b
        for slot, st in enumerate(self.slots):
            if st is None:
                continue
            tokens[slot] = st.token_at(st.fed)
            pos[slot] = st.fed
            active[slot] = True
            seeds[slot] = draw_seed(self.cfg.seed, st.req.rid, st.fed)
        if not active.any():
            return 0
        t0 = time.perf_counter()
        nxt, top = self._decode(tokens, pos, active, seeds)
        self.decode_step_s.append(time.perf_counter() - t0)
        self.decode_steps += 1
        for slot, st in enumerate(self.slots):
            if st is None:
                continue
            f = st.fed
            st.fed += 1
            self.decode_tokens += 1
            if f == st.known - 1:                # a new token, not replay
                st.generated.append(int(nxt[slot]))
                if top is not None:
                    self.top.setdefault(st.req.rid, []).append(
                        (top[0][slot], top[1][slot]))
            if len(st.generated) >= st.req.max_new_tokens:
                self._evict(slot)
        return 1

    # ----------------------------------------------------------- eviction --
    def _evict(self, slot: int):
        st = self.slots[slot]
        self.finished[st.req.rid] = np.asarray(st.generated, np.int32)
        recycled = self.pool.free([st.pages[l] for l in sorted(st.pages)])
        paging.release_slot(self.cache, slot, paging.build_block_table_row(
            recycled, self.cfg.pages_per_seq))
        self.slots[slot] = None

    def defrag(self):
        """Compact live pages to the low pool indices (host allocator,
        device pools, block tables and the slots' page maps together)."""
        old_to_new = self.pool.defrag()
        new_to_old = np.argsort(old_to_new).astype(np.int32)
        paging.apply_page_remap(self.cache, old_to_new, new_to_old)
        for st in self.slots:
            if st is not None:
                st.pages = {l: int(old_to_new[p])
                            for l, p in st.pages.items()}

    def step(self) -> List[int]:
        """One tick: admit -> bulk prefill -> one decode step (-> defrag).
        Returns the request ids finished in this tick."""
        before = set(self.finished)
        self._admit()
        # the high-water mark before this tick's evictions release pages
        self.peak_pages_in_use = max(self.peak_pages_in_use,
                                     self.pool.in_use)
        self._bulk_prefill()
        self._decode_tick()
        self.steps += 1
        if self.cfg.defrag_every and self.steps % self.cfg.defrag_every == 0:
            self.defrag()
        return sorted(set(self.finished) - before)

    def run(self, max_steps: int = 100_000) -> Dict[int, np.ndarray]:
        """Drain the queue; raises if it does not drain within
        ``max_steps`` ticks (reservation admission guarantees progress)."""
        for _ in range(max_steps):
            if not self.busy:
                return self.finished
            self.step()
        raise RuntimeError(f"stream not drained after {max_steps} steps")
