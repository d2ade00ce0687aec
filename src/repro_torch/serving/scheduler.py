"""Request scheduler with continuous batching over the paged cache (the
port of ``repro.serving.scheduler``), for attention and MoE stacks (KV
pages) and xLSTM and Mamba2 stacks (per-slot recurrent state, zeroed at
admission).

``max_seqs`` sequence slots share one page pool; a sequence that finishes
releases its slot and drops its page references at once, and the next
request is admitted as soon as the policy allows. Ties are broken
deterministically, so a replayed run makes the same decisions.

* **Admission**, two modes. By default (``preempt=False``) strict FIFO
  with head-of-line blocking: the oldest waiting request is admitted iff a
  slot is free and the pool can reserve its whole footprint,
  ceil((prompt + max_new_tokens) / page_size) pages less its shared
  prefix, so an admitted request always runs to completion.
  ``preempt=True`` is watermark admission: a request is admitted on its
  near-term need (its unshared prompt pages and ``decode_watermark``
  decode pages), decode pages are mapped when the sequence reaches them,
  and a low/high free-page watermark (``wm_low``/``wm_high``) gates
  admission with hysteresis. When the pool runs dry a victim is
  preempted (strictly lower priority first, the most recently admitted
  among equals) and re-queued; it resumes by recompute (its own tokens
  replayed, teacher-forced) or by swap (its pages and recurrent slot
  state written to an NPZ file and restored byte for byte;
  ``preempt_mode``). Waiting requests age (``aging_ticks``) so low
  priority cannot starve, and a missed ``deadline`` raises priority. Aging
  orders the queue and, frozen into the slot at admission, shields an
  aged-in runner; preemption triggers on base and deadline priority only,
  so an aged waiter never evicts a runner (both sides aging in lockstep
  would churn forever). A tick in which nothing could run forces one
  victim out (the liveness breaker).
* **Prefix sharing** (``share_prefix=True``, attention stacks only): full
  prompt pages are content-hashed, chained, into a
  :class:`paging.PrefixIndex`; admission maps matched pages into the new
  block table with a refcount instead of refilling them, and prefill
  starts after the shared region. The first write into a shared page
  (reachable only for an exactly page-aligned, fully matched prompt, whose
  re-fed last token lands in the last shared page) forks it
  copy-on-write. The decode kernels read pages only, so several rows of a
  block table may point at one page.
* **Chunked prefill**: an admitted prompt is written in exact
  ``prefill_chunk``-token chunks (batch-1 steps against the shared pools
  through ``paging.slice_slot``) from the end of its shared prefix; the
  rest, at least the last known token, rides the shared decode steps as
  teacher-forced tokens. Chunks are never padded, so recurrent state sees
  only real tokens; an xLSTM chunk runs the sLSTM cell kernel at (1,
  ``prefill_chunk``).
* **Decode**: one step for all slots per tick; inactive and stalled
  slots carry position -1 (their pool writes are dropped; their recurrent
  state moves and is zeroed again at the next admission, as in the JAX
  package). Greedy sampling is an argmax on the device; temperature
  sampling draws each slot's token with its own ``torch.Generator`` seeded
  from (seed, request id, position), so a request's draws do not depend
  on which requests share its batch, and a recomputed continuation redraws
  the same tokens.
* **Eviction** drops a finished request's page references (pages recycle
  at refcount 0 and leave the prefix index); ``defrag_every`` compacts
  live pages (content-, refcount- and sharing-preserving).
* **Latency**: TTFT from ``submit`` with its queueing part, inter-token
  gaps (preemption stalls included), decode-tick and prefill-chunk walls,
  each in a bounded window (``obs.metrics``), as in the JAX package.

:class:`AsyncServer` wraps the synchronous core for asyncio callers.

* **Tracing** (``obs.trace``, ``--trace``): with a tracer active, a span
  per request (its queue spans and prefill chunks inside, admit, preempt,
  swap_out, cow_fork and first_token instants) on a ``serving/req <rid>``
  track, and the decode_step spans, defrag and forced_preempt instants and
  the ``page_pool`` counter on ``serving/scheduler``, at the JAX package's
  sites. Each site is one ``is None`` test without a tracer; with one it
  records host decisions only, so the token streams and kernel launches
  are those of an untraced run.

* **SWA page recycling** (``swa_recycle=True``, stacks of sliding-window
  attention only): a page whose last position can never again fall inside
  the window (``(l+1)*page_size - 1 <= fed - window``) is dropped from the
  sequence's row after each fed chunk or token and freed through the
  refcounted pool (``swa_recycled_pages``, a ``swa_recycle`` instant), so a
  sequence's live pages are bounded by its window.

The JAX package's threefry keys cannot
be reproduced in PyTorch, so temperature sampling draws other tokens than
the JAX package's; greedy decoding is what the two are held equal on.
"""
from __future__ import annotations

import asyncio
import dataclasses
import os
import tempfile
import time
from collections import deque
from typing import Dict, List, Optional, Sequence, Set

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models import registry
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace
from repro_torch.serving import paging


def _env_kv_bits() -> int:
    """Default KV-page width; REPRO_SERVE_KV_BITS overrides."""
    return int(os.environ.get("REPRO_SERVE_KV_BITS", "32"))


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Scheduler and paged-cache geometry, and the production-load
    policies (all off by default, so the reservation FIFO is the
    out-of-the-box behaviour)."""
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
    share_prefix: bool = False        # copy-on-write prefix page sharing
    preempt: bool = False             # watermark admission + preemption
    preempt_mode: str = "recompute"   # "recompute" | "swap"
    decode_watermark: int = 2         # near-term decode pages at admission
    wm_low: float = 0.0               # close admission below this free frac
    wm_high: float = 0.0              # ... reopen at/above this free frac
    aging_ticks: int = 64             # waiting ticks per +1 eff. priority
    swa_recycle: bool = False         # free pages behind the SWA window

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
        if not (0.0 <= self.wm_low <= self.wm_high < 1.0):
            raise ValueError("need 0 <= wm_low <= wm_high < 1")
        if self.decode_watermark < 1 or self.aging_ticks < 1:
            raise ValueError("decode_watermark and aging_ticks must be >=1")


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray                # (plen,) int32
    max_new_tokens: int
    priority: int = 0                 # higher wins (admission and victims)
    deadline: Optional[int] = None    # scheduler tick; missing it escalates


@dataclasses.dataclass
class _WaitEntry:
    """A queued (or preempted and re-queued) request."""
    req: Request
    enq_step: int                                 # aging baseline
    generated: List[int] = dataclasses.field(default_factory=list)
    swap_path: Optional[str] = None               # NPZ of a swap preemption
    last_tok_t: Optional[float] = None            # inter-token continuity


@dataclasses.dataclass
class _Slot:
    req: Request
    pages: Dict[int, int]             # logical page -> physical page
    shared: Set[int]                  # logicals mapped copy-on-write
    fed: int                          # tokens already written to the cache
    bulk_end: int                     # prefill-chunk target (rest decodes)
    admit_step: int
    enq_step: int = 0                 # first enqueue tick (aging survives
    #                                   preemption)
    prio: int = 0                     # effective priority at admission
    generated: List[int] = dataclasses.field(default_factory=list)
    chain: bytes = paging.PrefixIndex.ROOT        # hash chain at next_reg
    next_reg: int = 0                 # next logical page to content-index
    last_tok_t: Optional[float] = None
    stalled: bool = False             # no page could be found this tick

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


def block_kinds(model_cfg) -> Set[str]:
    unit, n_full, rem = registry.segments(model_cfg)
    return (set(unit) if n_full else set()) | set(rem)


def pure_swa(model_cfg) -> bool:
    """Every block is sliding-window attention with a set window: the
    stacks whose pages SWA recycling may free."""
    return (block_kinds(model_cfg) == {"swa"}
            and getattr(model_cfg, "sliding_window", None) is not None)


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
        kinds = block_kinds(model_cfg)
        if cfg.share_prefix and not kinds <= set(paging._ATTN_KINDS):
            raise ValueError(
                "share_prefix requires a pure attention stack: recurrent "
                "state summarizes the whole prefix, so a shared page "
                f"cannot skip its prefill (got kinds {sorted(kinds)})")
        if cfg.swa_recycle and not pure_swa(model_cfg):
            raise ValueError(
                "swa_recycle requires every block to be sliding-window "
                f"attention with a set window (got kinds {sorted(kinds)})")
        dtype = (torch.bfloat16 if cfg.cache_dtype == "bfloat16"
                 else torch.float32)
        self.cache = paging.init_paged_cache(
            model_cfg, cfg.max_seqs, cfg.num_pages, cfg.page_size,
            cfg.pages_per_seq, dtype, kv_bits=cfg.kv_bits,
            device=self.device)
        self.pool = paging.PagePool(cfg.num_pages)
        self.index = (paging.PrefixIndex(cfg.page_size)
                      if cfg.share_prefix else None)
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
        self._gate_closed = False
        self._swap_dir: Optional[str] = None
        self.cow_forks = 0
        self.preemptions = 0
        self.forced_preemptions = 0
        self.swa_recycled_pages = 0
        self.shared_page_hits = 0           # logical pages mapped via index
        self.pages_alloc_events = 0         # pages physically allocated
        # bounded latency windows (a long-lived server must not grow
        # without limit), the JAX package's sizes: host wall seconds of
        # each decode tick and prefill chunk (each ending in a device
        # synchronisation), inter-token gaps, and per-request TTFT from
        # submit with its queueing part (submit -> first admission)
        self.decode_step_s = obs_metrics.Histogram("serve_decode_step_s",
                                                   window=4096)
        self.prefill_chunk_s = obs_metrics.Histogram(
            "serve_prefill_chunk_s", window=4096)
        self.itl_s = obs_metrics.Histogram("serve_itl_s", window=8192)
        self.ttft_s = obs_metrics.BoundedDict(4096)
        self.ttft_queue_s = obs_metrics.BoundedDict(4096)
        self._submit_t: Dict[int, float] = {}
        self.record_top = record_top
        self.top: Dict[int, List] = {}

    # ------------------------------------------------------------- intake --
    def submit(self, prompt: Sequence[int], max_new_tokens: int,
               priority: int = 0, deadline: Optional[int] = None) -> int:
        prompt = np.asarray(prompt, np.int32)
        total = len(prompt) + max_new_tokens
        need = paging.pages_needed(total, self.cfg.page_size)
        if len(prompt) < 1 or max_new_tokens < 1:
            raise ValueError("need a non-empty prompt and max_new_tokens>=1")
        headroom = (1 + self.cfg.decode_watermark) if self.cfg.preempt else 0
        if total > self.cfg.max_context or \
                need + headroom > self.cfg.num_pages:
            raise ValueError(
                f"request of {total} tokens exceeds the serve capacity "
                f"(max_context={self.cfg.max_context}, "
                f"num_pages={self.cfg.num_pages})")
        rid = self._next_rid
        self._next_rid += 1
        self._submit_t[rid] = time.perf_counter()
        self.waiting.append(_WaitEntry(
            Request(rid, prompt, int(max_new_tokens), int(priority),
                    deadline), self.steps))
        tr = obs_trace.tracer()
        if tr is not None:
            tid = tr.track("serving", f"req {rid}")
            tr.begin("request", "serving", tid,
                     args={"rid": rid, "prompt": int(len(prompt)),
                           "max_new": int(max_new_tokens),
                           "priority": int(priority)})
            tr.begin("queue", "serving", tid)
        return rid

    @property
    def busy(self) -> bool:
        return bool(self.waiting) or any(s is not None for s in self.slots)

    # --------------------------------------------------------- accounting --
    def _alloc(self, n: int) -> List[int]:
        self.pages_alloc_events += n
        return self.pool.alloc(n)

    def _free(self, phys: Sequence[int]) -> List[int]:
        recycled = self.pool.free(phys)
        if self.index is not None:
            for p in recycled:
                self.index.drop_page(p)
        return recycled

    def _preempt_priority(self, e: _WaitEntry) -> int:
        """Priority that can trigger a preemption: base and deadline
        escalation, no aging term. A merely aged waiter must not evict a
        runner: with both sides aging in lockstep that turns into endless
        preempt/readmit churn where recompute replay eats every residency
        (a livelock)."""
        p = e.req.priority
        if e.req.deadline is not None and self.steps > e.req.deadline:
            p += 1 + (self.steps - e.req.deadline) // self.cfg.aging_ticks
        return p

    def _eff_priority(self, e: _WaitEntry) -> int:
        return (self._preempt_priority(e)
                + (self.steps - e.enq_step) // self.cfg.aging_ticks)

    # ---------------------------------------------------- admission plans --
    def _plan(self, e: _WaitEntry) -> Dict:
        """What admitting ``e`` takes: the shared-prefix hits, the first
        token to (re)feed, and the fresh-page bill of each mode."""
        ps = self.cfg.page_size
        req = e.req
        plen = len(req.prompt)
        known = plen + len(e.generated)
        seq = (np.concatenate([req.prompt, np.asarray(e.generated, np.int32)])
               if e.generated else req.prompt)
        total_pages = paging.pages_needed(plen + req.max_new_tokens, ps)
        k, shared, chain = 0, {}, paging.PrefixIndex.ROOT
        if self.index is not None:
            for h in self.index.hash_chain(seq):
                page = self.index.lookup(h)
                if page is None:
                    break
                shared[k] = page
                chain = h
                k += 1
        s0 = min(k * ps, known - 1)
        fork = k * ps > s0          # the re-fed tail token hits a shared page
        fresh_prompt = list(range(k, (known - 1) // ps + 1))
        return dict(req=req, seq=seq, known=known, total_pages=total_pages,
                    k=k, shared=shared, chain=chain, s0=s0, fork=fork,
                    fresh_prompt=fresh_prompt)

    def _near_need(self, e: _WaitEntry, plan: Optional[Dict] = None) -> int:
        """Pages a watermark admission allocates now or imminently."""
        if e.swap_path is not None:
            with np.load(e.swap_path) as meta:
                return len(meta["logicals"]) + self.cfg.decode_watermark
        plan = plan or self._plan(e)
        return (len(plan["fresh_prompt"]) + (1 if plan["fork"] else 0)
                + self.cfg.decode_watermark)

    # -------------------------------------------------------------- admit --
    def _admit(self) -> int:
        if self.cfg.preempt:
            return self._admit_watermark()
        return self._admit_reserve()

    def _admit_reserve(self) -> int:
        admitted = 0
        while self.waiting:
            e = self.waiting[0]
            free_slots = [i for i, s in enumerate(self.slots) if s is None]
            if not free_slots:
                return admitted
            plan = self._plan(e)
            need = (plan["total_pages"] - plan["k"]
                    + (1 if plan["fork"] else 0))
            if not self.pool.can_alloc(need):
                return admitted          # FIFO head-of-line blocking
            self.waiting.popleft()
            self._admit_entry(e, free_slots[0], plan, reserve=True)
            admitted += 1
        return admitted

    def _admit_watermark(self) -> int:
        cfg = self.cfg
        if self._gate_closed and \
                self.pool.free_count >= cfg.wm_high * cfg.num_pages:
            self._gate_closed = False
        admitted = 0
        while self.waiting:
            e = min(self.waiting,
                    key=lambda w: (-self._eff_priority(w), w.req.rid))
            free_slots = [i for i, s in enumerate(self.slots) if s is None]
            if not free_slots:
                victim = self._pick_victim(set(), self._preempt_priority(e))
                if victim is None:
                    break
                self._preempt(victim)
                continue
            if self._gate_closed:
                break
            plan = None if e.swap_path else self._plan(e)
            near = self._near_need(e, plan)
            if not self.pool.can_alloc(near):
                victim = self._pick_victim(set(), self._preempt_priority(e))
                if victim is None:
                    break
                self._preempt(victim)
                continue
            if self.pool.free_count - near < cfg.wm_low * cfg.num_pages:
                self._gate_closed = True
                if any(s is not None for s in self.slots):
                    break               # drain below the low watermark
            self.waiting.remove(e)
            self._admit_entry(e, free_slots[0],
                              plan if e.swap_path is None else None,
                              reserve=False)
            admitted += 1
        return admitted

    def _admit_entry(self, e: _WaitEntry, slot: int,
                     plan: Optional[Dict], reserve: bool):
        rid = e.req.rid
        if rid not in self.ttft_queue_s and rid in self._submit_t:
            self.ttft_queue_s[rid] = time.perf_counter() - self._submit_t[rid]
        tr = obs_trace.tracer()
        if tr is not None:
            tid = tr.track("serving", f"req {rid}")
            tr.end("serving", tid)      # close the queue span
            tr.instant("admit", "serving", tid,
                       args={"slot": slot,
                             "swapped": e.swap_path is not None})
        if e.swap_path is not None:
            self._admit_swapped(e, slot)
            return
        plan = plan or self._plan(e)
        pps = self.cfg.pages_per_seq
        k, shared, s0 = plan["k"], plan["shared"], plan["s0"]
        fresh_logicals = (list(range(k, plan["total_pages"])) if reserve
                          else plan["fresh_prompt"])
        self.pool.retain(shared.values())
        fresh = self._alloc(len(fresh_logicals) + (1 if plan["fork"] else 0))
        fork_dst = fresh.pop() if plan["fork"] else None
        pages = dict(shared)
        pages.update(zip(fresh_logicals, fresh))
        row = np.full((pps,), -1, np.int32)
        for l, p in pages.items():
            row[l] = p
        fresh_row = paging.build_block_table_row(
            fresh + ([fork_dst] if plan["fork"] else []), pps)
        paging.admit_slot(self.cache, slot, row, fresh_row)
        shared_set = set(shared)
        if plan["fork"]:
            # the re-fed last token writes into the last shared page: fork
            # it now, so the reservation stays whole and no slot ever
            # writes a page another one reads
            src = pages[k - 1]
            paging.fork_pages(self.cache, slot, [k - 1], [src], [fork_dst],
                              s0)
            pages[k - 1] = fork_dst
            shared_set.discard(k - 1)
            recycled = self._free([src])
            assert not recycled, "forked a page nobody else referenced"
            self.cow_forks += 1
            if tr is not None:
                tr.instant("cow_fork", "serving", tid,
                           args={"logical": k - 1, "at": "admit"})
        chunk = self.cfg.prefill_chunk
        bulk_end = s0 + ((plan["known"] - 1 - s0) // chunk) * chunk
        self.slots[slot] = _Slot(
            e.req, pages, shared_set, fed=s0, bulk_end=bulk_end,
            admit_step=self.steps, enq_step=e.enq_step,
            prio=self._eff_priority(e), generated=list(e.generated),
            chain=plan["chain"], next_reg=k, last_tok_t=e.last_tok_t)
        self.shared_page_hits += k

    def _admit_swapped(self, e: _WaitEntry, slot: int):
        """Rebind a swapped-out sequence: fresh physical pages, the pool
        slabs restored byte for byte, the recurrent slot state put back."""
        pps = self.cfg.pages_per_seq
        with np.load(e.swap_path) as data:
            data = {key: data[key] for key in data.files}
        logicals = [int(l) for l in data["logicals"]]
        fresh = self._alloc(len(logicals))
        row = np.full((pps,), -1, np.int32)
        for l, p in zip(logicals, fresh):
            row[l] = p
        paging.admit_slot(self.cache, slot, row,
                          paging.build_block_table_row(fresh, pps))
        paging.insert_pages(self.cache, {key[5:]: v for key, v in data.items()
                                         if key.startswith("pool|")}, fresh)
        paging.insert_seq_state(self.cache,
                                {key[4:]: v for key, v in data.items()
                                 if key.startswith("seq|")}, slot)
        fed = int(data["fed"])
        self.slots[slot] = _Slot(
            e.req, dict(zip(logicals, fresh)), set(), fed=fed, bulk_end=fed,
            admit_step=self.steps, enq_step=e.enq_step,
            prio=self._eff_priority(e), generated=list(e.generated),
            chain=bytes(data["chain"].tobytes()),
            next_reg=int(data["next_reg"]), last_tok_t=e.last_tok_t)
        os.remove(e.swap_path)
        e.swap_path = None

    # --------------------------------------------------------- preemption --
    def _pick_victim(self, exclude: Set[int],
                     below_priority: Optional[int] = None) -> Optional[int]:
        """Victim slot: lowest admission-time priority first (an aged
        request keeps its boost while it runs), the most recently admitted
        among equals. ``below_priority`` restricts to strictly lower
        priority (None: any slot, the liveness breaker)."""
        cands = [(st.prio, -st.admit_step, i)
                 for i, st in enumerate(self.slots)
                 if st is not None and i not in exclude]
        if below_priority is not None:
            cands = [c for c in cands if c[0] < below_priority]
        return min(cands)[2] if cands else None

    def _preempt(self, slot: int):
        st = self.slots[slot]
        entry = _WaitEntry(st.req, st.enq_step, generated=list(st.generated),
                           last_tok_t=st.last_tok_t)
        if self.cfg.preempt_mode == "swap":
            entry.swap_path = self._swap_out(slot, st)
        recycled = self._free([st.pages[l] for l in sorted(st.pages)])
        paging.release_slot(self.cache, slot, paging.build_block_table_row(
            recycled, self.cfg.pages_per_seq))
        self.slots[slot] = None
        self.waiting.append(entry)
        self.preemptions += 1
        tr = obs_trace.tracer()
        if tr is not None:
            tid = tr.track("serving", f"req {st.req.rid}")
            tr.instant("preempt", "serving", tid,
                       args={"slot": slot, "mode": self.cfg.preempt_mode,
                             "generated": len(st.generated)})
            if entry.swap_path is not None:
                tr.instant("swap_out", "serving", tid)
            tr.begin("queue", "serving", tid)   # re-queued until re-admit

    def _swap_out(self, slot: int, st: _Slot) -> str:
        if self._swap_dir is None:
            self._swap_dir = tempfile.mkdtemp(prefix="repro-serve-swap-")
        logicals = sorted(st.pages)
        slabs = paging.extract_pages(self.cache,
                                     [st.pages[l] for l in logicals])
        seq_state = paging.extract_seq_state(self.cache, slot)
        path = os.path.join(self._swap_dir, f"rid{st.req.rid}.npz")
        np.savez(path, logicals=np.asarray(logicals, np.int32),
                 fed=np.int64(st.fed), next_reg=np.int64(st.next_reg),
                 chain=np.frombuffer(st.chain, np.uint8),
                 **{f"pool|{k}": v for k, v in slabs.items()},
                 **{f"seq|{k}": v for k, v in seq_state.items()})
        return path

    @property
    def swap_dir(self) -> Optional[str]:
        """The directory swap preemption writes to (None until the first
        swap-out); empty once every swapped request is readmitted."""
        return self._swap_dir

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
        tr = obs_trace.tracer()
        for slot, st in enumerate(self.slots):
            if st is None:
                continue
            while st.fed < st.bulk_end:
                f0 = st.fed
                tid = None
                if tr is not None:
                    tid = tr.track("serving", f"req {st.req.rid}")
                    tr.begin("prefill_chunk", "serving", tid,
                             args={"from": f0, "chunk": chunk})
                toks = np.array([st.token_at(i)
                                 for i in range(f0, f0 + chunk)],
                                np.int32)[None, :]
                pos = np.arange(f0, f0 + chunk, dtype=np.int32)[None, :]
                t0 = time.perf_counter()
                self._prefill_chunk(slot, toks, pos)
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
                self.prefill_chunk_s.observe(time.perf_counter() - t0)
                self.prefill_chunks += 1
                self.prefill_tokens += chunk
                ran += 1
                st.fed += chunk
                self._after_progress(slot, st)
                if tid is not None:
                    tr.end("serving", tid)
        return ran

    # ------------------------------------------------------------- decode --
    def _ensure_writable(self, slot: int, st: _Slot) -> bool:
        """Make sure position ``st.fed`` has a page of its own before the
        decode write: map a fresh page (watermark mode) or fork a shared
        one. May preempt. False if no page could be had (the slot stalls
        this tick)."""
        l = st.fed // self.cfg.page_size
        if l in st.pages and l not in st.shared:
            return True
        while not self.pool.can_alloc(1):
            if not self.cfg.preempt:
                return False
            victim = self._pick_victim({slot}, st.req.priority)
            if victim is None:
                return False
            self._preempt(victim)
        if l in st.shared:
            src = st.pages[l]
            dst = self._alloc(1)[0]
            paging.fork_pages(self.cache, slot, [l], [src], [dst], st.fed)
            st.pages[l] = dst
            st.shared.discard(l)
            recycled = self._free([src])
            assert not recycled, "forked a page nobody else referenced"
            self.cow_forks += 1
            tr = obs_trace.tracer()
            if tr is not None:
                tr.instant("cow_fork", "serving",
                           tr.track("serving", f"req {st.req.rid}"),
                           args={"logical": l, "at": "decode"})
        else:
            page = self._alloc(1)[0]
            paging.map_pages(self.cache, slot, [l], [page])
            st.pages[l] = page
        return True

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
        # page resolution first: it may preempt slots, so the batch is
        # built from the survivors
        for slot in range(b):
            st = self.slots[slot]
            if st is not None:
                st.stalled = not self._ensure_writable(slot, st)
        tokens = np.zeros((b,), np.int32)
        pos = np.zeros((b,), np.int32)
        active = np.zeros((b,), bool)
        seeds = [0] * b
        for slot, st in enumerate(self.slots):
            if st is None or st.stalled:
                continue
            tokens[slot] = st.token_at(st.fed)
            pos[slot] = st.fed
            active[slot] = True
            seeds[slot] = draw_seed(self.cfg.seed, st.req.rid, st.fed)
        if not active.any():
            return 0
        tr = obs_trace.tracer()
        sched_tid = tr.track("serving", "scheduler") if tr is not None else 0
        if tr is not None:
            tr.begin("decode_step", "serving", sched_tid,
                     args={"active": int(active.sum())})
        t0 = time.perf_counter()
        nxt, top = self._decode(tokens, pos, active, seeds)
        now = time.perf_counter()
        if tr is not None:
            tr.end("serving", sched_tid)
        self.decode_step_s.observe(now - t0)
        self.decode_steps += 1
        for slot, st in enumerate(self.slots):
            if st is None or st.stalled:
                continue
            f = st.fed
            st.fed += 1
            self.decode_tokens += 1
            if f == st.known - 1:                # a new token, not replay
                st.generated.append(int(nxt[slot]))
                if top is not None:
                    self.top.setdefault(st.req.rid, []).append(
                        (top[0][slot], top[1][slot]))
                if st.last_tok_t is not None:
                    self.itl_s.observe(now - st.last_tok_t)
                st.last_tok_t = now
                if len(st.generated) == 1:
                    t_sub = self._submit_t.pop(st.req.rid, None)
                    if t_sub is not None:
                        self.ttft_s[st.req.rid] = now - t_sub
                    if tr is not None:
                        tr.instant(
                            "first_token", "serving",
                            tr.track("serving", f"req {st.req.rid}"))
            self._after_progress(slot, st)
            if len(st.generated) >= st.req.max_new_tokens:
                self._evict(slot)
        return 1

    def _after_progress(self, slot: int, st: _Slot):
        """After ``st.fed`` advances: content-index the pages it
        completed (with sharing on), then drop the pages that fell wholly
        behind the SWA window (with ``swa_recycle``)."""
        ps = self.cfg.page_size
        if self.index is not None:
            while (st.next_reg + 1) * ps <= st.fed:
                l = st.next_reg
                toks = np.array([st.token_at(i)
                                 for i in range(l * ps, (l + 1) * ps)],
                                np.int32)
                st.chain = paging.PrefixIndex.chain(st.chain, toks)
                if l in st.pages and l not in st.shared:
                    self.index.register(st.chain, st.pages[l])
                st.next_reg += 1
        if self.cfg.swa_recycle:
            window = self.model_cfg.sliding_window
            dead = [l for l in sorted(st.pages)
                    if (l + 1) * ps - 1 <= st.fed - window]
            if dead:
                phys = [st.pages.pop(l) for l in dead]
                st.shared.difference_update(dead)
                recycled = self._free(phys)
                paging.unmap_pages(self.cache, slot, dead,
                                   paging.build_block_table_row(
                                       recycled, self.cfg.pages_per_seq))
                self.swa_recycled_pages += len(dead)
                tr = obs_trace.tracer()
                if tr is not None:
                    tr.instant("swa_recycle", "serving",
                               tr.track("serving", f"req {st.req.rid}"),
                               args={"pages": len(dead)})

    # ----------------------------------------------------------- eviction --
    def _evict(self, slot: int):
        st = self.slots[slot]
        self.finished[st.req.rid] = np.asarray(st.generated, np.int32)
        tr = obs_trace.tracer()
        if tr is not None:
            tr.end("serving", tr.track("serving", f"req {st.req.rid}"),
                   args={"tokens": len(st.generated)})   # close "request"
        recycled = self._free([st.pages[l] for l in sorted(st.pages)])
        paging.release_slot(self.cache, slot, paging.build_block_table_row(
            recycled, self.cfg.pages_per_seq))
        self.slots[slot] = None

    def defrag(self):
        """Compact live pages to the low pool indices (host allocator,
        device pools, block tables, the slots' page maps and the prefix
        index together). A page several tables map moves once and every
        row follows it."""
        tr = obs_trace.tracer()
        if tr is not None:
            tr.instant("defrag", "serving", tr.track("serving", "scheduler"),
                       args={"in_use": self.pool.in_use})
        old_to_new = self.pool.defrag()
        new_to_old = np.argsort(old_to_new).astype(np.int32)
        paging.apply_page_remap(self.cache, old_to_new, new_to_old)
        for st in self.slots:
            if st is not None:
                st.pages = {l: int(old_to_new[p])
                            for l, p in st.pages.items()}
        if self.index is not None:
            self.index.remap(old_to_new)

    def step(self) -> List[int]:
        """One tick: admit -> bulk prefill -> one decode step (-> defrag).
        Returns the request ids finished in this tick."""
        before = set(self.finished)
        admitted = self._admit()
        # the high-water mark before this tick's evictions release pages
        self.peak_pages_in_use = max(self.peak_pages_in_use,
                                     self.pool.in_use)
        prefilled = self._bulk_prefill()
        decoded = self._decode_tick()
        self.steps += 1
        if self.cfg.defrag_every and self.steps % self.cfg.defrag_every == 0:
            self.defrag()
        if not (admitted or prefilled or decoded) and self.busy \
                and self.cfg.preempt \
                and any(s is not None for s in self.slots):
            # liveness breaker: every slot stalled on a dry pool with no
            # strictly lower-priority victim (equal priorities wedged
            # against each other): force one out so the rest run
            victim = self._pick_victim(set())
            if victim is not None:
                self._preempt(victim)
                self.forced_preemptions += 1
                tr = obs_trace.tracer()
                if tr is not None:
                    tr.instant("forced_preempt", "serving",
                               tr.track("serving", "scheduler"))
        tr = obs_trace.tracer()
        if tr is not None:
            refs, shared = self.pool.ref_stats()
            tr.counter("page_pool", "serving", {
                "free": self.pool.free_count,
                "in_use": self.pool.in_use,
                "refs": refs,
                "shared": shared,
            }, tid=tr.track("serving", "scheduler"))
        return sorted(set(self.finished) - before)

    def run(self, max_steps: int = 100_000) -> Dict[int, np.ndarray]:
        """Drain the queue. Raises if it does not drain within
        ``max_steps`` ticks (a liveness fault: reservation admission
        guarantees progress, and watermark mode has the forced-preemption
        breaker)."""
        for _ in range(max_steps):
            if not self.busy:
                return self.finished
            self.step()
        raise RuntimeError(f"stream not drained after {max_steps} steps")


class AsyncServer:
    """asyncio facade: ``await generate(prompt, max_new)`` returns the
    generated tokens; one pump task advances the scheduler while any
    request is pending, yielding between ticks."""

    def __init__(self, scheduler: Scheduler):
        self.scheduler = scheduler
        self._events: Dict[int, asyncio.Event] = {}
        self._abandoned: set = set()
        self._pump_task: Optional[asyncio.Task] = None

    async def generate(self, prompt: Sequence[int], max_new_tokens: int,
                       priority: int = 0,
                       deadline: Optional[int] = None) -> np.ndarray:
        rid = self.scheduler.submit(prompt, max_new_tokens,
                                    priority=priority, deadline=deadline)
        ev = asyncio.Event()
        self._events[rid] = ev
        if self._pump_task is None or self._pump_task.done():
            self._pump_task = asyncio.ensure_future(self._pump())
        delivered = False
        try:
            await ev.wait()
            # pop the result: a long-running server keeps no finished
            # request's tokens
            result = self.scheduler.finished.pop(rid)
            delivered = True
            return result
        finally:
            # on cancellation (a client gone) the stale event must not keep
            # the pump alive, and the request's eventual output is reaped
            self._events.pop(rid, None)
            if not delivered:
                self._abandoned.add(rid)

    async def _pump(self):
        # abandoned results alone (scheduler idle) still need one reap pass
        while self._events or self._abandoned:
            if self.scheduler.busy:
                done = self.scheduler.step()
            else:
                done = list(self.scheduler.finished)
            for rid in done:
                ev = self._events.get(rid)
                if ev is not None:
                    ev.set()
            for rid in list(self._abandoned):
                if self.scheduler.finished.pop(rid, None) is not None:
                    self._abandoned.discard(rid)
            await asyncio.sleep(0)
