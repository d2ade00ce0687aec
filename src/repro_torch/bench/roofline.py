"""Roofline stage (the ``roofline`` stage of campaign ``all``): each of the
port's kernels at its full-width shape against the least time an H100
could take for the same work. The JAX stage reads TPU dry-run records
(``launch/dryrun.py``, not ported); this is its counterpart on the card,
with the same section ``("roofline",)`` and claim
``roofline_no_failed_records``.

A row's bound is the larger of two times: the bytes the call must move
(each input read once, each output written once) at the card's memory
rate, and its operations at the float32 rate outside the tensor cores
(``PEAK_BYTES_PER_S``, ``PEAK_F32_FLOPS``: one H100 SXM at 700 W, NVIDIA's
data sheet). Its device time is the median over rounds of CUDA events
around back-to-back calls, and its share is bound / time. The work
functions here (``quant_work``, ``mix_work``, ``grouped_work``,
``edge_work``, ``paged_work``, ``slstm_work``) are the only place these
bytes and operations are reckoned: ``chip_smoke.py``'s bounds call them.

Rows (``single``): B1 and B2 at the convex (64, 2000), B2 also at
(1024, 2000); B2, B3, B4, B5 and B6 at xlstm-125m's packed buffer (4,
134,277,912), G=19; B6 also on ``star_graph(257)`` at d = 2000; B7 at
tinyllama-1.1b's decode geometry, the 16-request stream's shape (bf16
pools) and the production-load shape (84-page tables, float32 pools); B8
at the 3,968 + 32 token request; B9 at (1, 64) and (8, 700). ``multi``:
the sharded backend's (N/w, N) row-block B2 at 2 and 4 ranks of the
convex and LM shapes; the all-gather before it is not timed on one card.
The library column is one PyTorch call that computes the same function:
``torch.matmul`` for B2 and B6 (over the dense adjacency), SDPA over K/V
gathered beforehand for B7 and B8.

A row is ``fail`` when its launch raises or its share exceeds 1.05, which
no card can give; on the CPU every row is ``missing`` (bytes and bound, no
time), which the claim takes as informational, as the JAX stage does.

    PYTHONPATH=src python -m repro_torch.launch.train --campaign all \\
        --campaign-only roofline [--device cpu]
"""
from __future__ import annotations

import dataclasses
import statistics
import subprocess
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.campaign.store import Claim, Record
from repro_torch.device import resolve_device

PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
# float32 operations of the quantizer per element: sub, add, div, floor,
# sub, compare, add, max, min, mul, add, sub (and 2 per row for 2R/Δ)
QUANT_OPS_PER_ELEM = 12
# bytes per element of a grouped quantize round: three operands read once
# and the reconstruction written once (the (N, G) side arrays are left out)
GROUPED_BYTES_PER_ELEM = 16
# float32 operations per (row, step, unit) of the sLSTM cell outside the
# product: 4 pre adds, fbias add, logsigmoid (6), m' (2), the two
# exponentials (3 + 2), c' (4), n' (3), h' (6)
SLSTM_GATE_OPS = 31
SHARE_LIMIT = 1.05
# tinyllama-1.1b's serving geometry (B, H, KV, hd, page size, table pages)
# and contexts, as chip_smoke.py serves it
SERVE_LENS = (17, 96, 255, 512, 700, 33, 384, 128)
SERVE_NEW, LOAD_PREFIX = 128, 512
LONG_PROMPT, LONG_NEW = 3968, 32
SLSTM_H, SLSTM_DH = 4, 192                   # xlstm-125m's sLSTM heads
ROW_BLOCKS = {"convex 2 ranks (32, 64) x (64, 2000)": (32, 64, 2000),
              "convex 4 ranks (16, 64) x (64, 2000)": (16, 64, 2000),
              "LM 2 ranks (2, 4) x (4, 4194304)": (2, 4, 1 << 22),
              "LM 4 ranks (1, 4) x (4, 4194304)": (1, 4, 1 << 22)}
MULTI_NOTE = ("row-block B2 of the sharded backend as one rank of 2 or 4 "
              "runs it; the all-gather of the value rows before it is not "
              "timed on one card")


# ----------------------------------------------------------- the work --
def bound(n_bytes: float, n_ops: float) -> Tuple[float, str]:
    """Least time in ms and what sets it: ``"bytes"`` or
    ``"operations"``."""
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def quant_work(n: int, d: int) -> Tuple[float, float]:
    """B1: theta, q_prev, uniforms read, out written; delta and range."""
    return 4.0 * (4 * n * d + 2 * n), QUANT_OPS_PER_ELEM * n * d + 2 * n


def mix_work(m: int, n: int, d: int) -> Tuple[float, float]:
    """B2 on an (M, N) adjacency and (N, d) float32 values."""
    return 4.0 * (m * n + n * d + m * d), 2.0 * m * n * d


def grouped_work(n_el: int) -> Tuple[float, float]:
    """B3, B4 and B5 on a packed buffer of ``n_el`` elements."""
    return (float(GROUPED_BYTES_PER_ELEM * n_el),
            float(QUANT_OPS_PER_ELEM * n_el))


def edge_bytes(graph, d: int) -> Tuple[float, float]:
    """B6's (unique, gathered) bytes: V's rows that a valid slot reads,
    once, or every slot's row, padded ones included; plus out written once
    and the (N, S) table and validity read once."""
    table, valid = graph.neighbor_table
    side = 4.0 * graph.n * d + 8.0 * table.size
    referenced = np.unique(table[valid > 0]).size
    return 4.0 * referenced * d + side, 4.0 * table.size * d + side


def edge_work(graph, d: int) -> Tuple[float, float]:
    """B6: the unique bytes and one multiply-add per valid slot and
    column."""
    _, valid = graph.neighbor_table
    return edge_bytes(graph, d)[0], 2.0 * float(valid.sum()) * d


def paged_work(shape, ctx: Sequence[int], kv_bits: int, online: bool,
               pool_bytes: int = 2) -> Tuple[float, float]:
    """B7/B8 on (B, H, KV, hd, page size, table pages): the K/V entries
    (and ranges) of the pages up to ctx (where ctx = 0: all the table's
    pages for the one-shot contract's uniform average, none for the online
    one), q, out, table and ctx, each once; 4·H·hd operations a slot."""
    bsz, heads, num_kv, hd, ps, pps = shape
    slots = sum((-(-c // ps) if c else (0 if online else pps)) * ps
                for c in ctx)
    entry = {32: pool_bytes * hd, 8: hd + 4, 4: hd // 2 + 4}[kv_bits]
    n_bytes = (2 * slots * num_kv * entry + 2 * 4 * bsz * heads * hd
               + 4 * bsz * pps + 4 * bsz)
    return float(n_bytes), 4.0 * heads * hd * slots


def slstm_work(dims, wx_bytes: int) -> Tuple[float, float]:
    """B9 on (B, S, H, dh): wx, R, fbias and the state read once, hs and
    the state written once; the product's 2 B S H dh 4dh and
    ``SLSTM_GATE_OPS`` per (row, step, unit)."""
    b, s, h, dh = dims
    n_bytes = (b * s * h * 4 * dh * wx_bytes + 4 * b * s * h * dh
               + 4 * h * dh * 4 * dh + 4 * h * dh + 8 * 4 * b * h * dh)
    n_ops = 2.0 * b * s * h * dh * 4 * dh + SLSTM_GATE_OPS * b * s * h * dh
    return float(n_bytes), n_ops


def lm_leaf_dims() -> Tuple[int, ...]:
    """Per-leaf parameter counts of xlstm-125m at full width (meta
    tensors: shapes only)."""
    from repro_torch.configs import base
    from repro_torch.core import tree as T
    from repro_torch.models import registry

    tree = registry.init_params(base.get_config("xlstm-125m"),
                                device="meta")
    return tuple(int(np.prod(x.shape)) for x in T.leaves(tree))


def stream_ctx() -> Tuple[int, ...]:
    """The 16-request stream's mid-decode contexts."""
    return tuple(n + SERVE_NEW // 2 for n in SERVE_LENS)


def load_ctx() -> Tuple[int, ...]:
    """The production-load stream's mid-decode contexts (a 512-token
    shared prompt before each length)."""
    return tuple(LOAD_PREFIX + n + SERVE_NEW // 2 for n in SERVE_LENS)


def long_ctx() -> Tuple[int, ...]:
    """The 3,968 + 32 token request mid-decode, beside 7 empty slots."""
    return (LONG_PROMPT + LONG_NEW // 2,) + (0,) * 7


# ------------------------------------------------------------- the rows --
@dataclasses.dataclass(frozen=True)
class Row:
    """One kernel at one shape: its work and, for the card, the maker
    of ``(kernel call, library call or None)`` on a device."""

    mesh: str
    kernel: str                    # "B1".."B9"
    name: str                      # the ops entry point
    shape: str
    work: Tuple[float, float]
    make: Callable[[torch.device], Tuple[Callable, Optional[Callable]]]
    library: Optional[str] = None
    reps: int = 100


def _gen(dev, seed):
    return torch.Generator(device=dev).manual_seed(seed)


def _quant_row(n, d):
    def make(dev):
        from repro_torch.kernels import ops
        g = _gen(dev, 0)
        theta = torch.randn((n, d), generator=g, device=dev)
        qprev = torch.randn((n, d), generator=g, device=dev)
        unif = torch.rand((n, d), generator=g, device=dev)
        qrange = (theta - qprev).abs().amax(dim=1)
        args = (theta, qprev, unif, 2.0 * qrange / 255.0, qrange)
        return (lambda: ops.stoch_quantize(*args)), None
    return Row("single", "B1", "stoch_quantize", f"({n}, {d})",
               quant_work(n, d), make)


def _mix_row(mesh, label, m, n, d, reps):
    def make(dev):
        from repro_torch.kernels import ops
        g = _gen(dev, 1)
        adj = (torch.rand((m, n), generator=g, device=dev) < 0.35).float()
        vals = torch.randn((n, d), generator=g, device=dev)
        return ((lambda: ops.bipartite_mix(adj, vals)),
                (lambda: torch.matmul(adj, vals)))
    return Row(mesh, "B2", "bipartite_mix", label, mix_work(m, n, d), make,
               library="torch.matmul", reps=reps)


def _grouped_row(kernel, name, dims, n):
    def make(dev):
        from repro_torch.core import packing
        from repro_torch.core.quantization import bit_schedule
        from repro_torch.kernels import ops, ref
        kw = dict(omega=0.9995, b0=6, b_max=16)
        tree = {f"k{i:02d}": torch.empty((n, d), device="meta")
                for i, d in enumerate(dims)}
        pk = packing.make_packing(tree, tuple(range(len(dims))))
        g = _gen(dev, 99)
        shape, groups = (n, pk.dim), pk.n_groups
        theta = 3.0 * torch.randn(shape, generator=g, device=dev)
        qprev = 3.0 * torch.randn(shape, generator=g, device=dev)
        unif = torch.rand(shape, generator=g, device=dev)
        bits = torch.randint(2, 9, (n, groups), generator=g,
                             device=dev).float()
        rprev = 8.0 * torch.rand((n, groups), generator=g, device=dev)
        init = torch.ones((n, groups), device=dev)
        args = (theta, qprev, unif, bits, rprev, init)
        runs = pk.group_runs
        if name == "stoch_quantize_grouped_fused":
            return (lambda: ops.stoch_quantize_grouped_fused(
                *args, None, group_runs=runs, **kw)), None
        if name == "stoch_quantize_grouped_fused_tiled":
            return (lambda: ops.stoch_quantize_grouped_fused_tiled(
                *args, None, group_runs=runs, block_d=512, **kw)), None
        rng_new = ref.grouped_range_ref(theta - qprev, runs)
        _, delta, _ = bit_schedule(bits, rng_new, rprev, init, **kw)
        return (lambda: ops.stoch_quantize_grouped(
            theta, qprev, unif, delta, rng_new, None, group_runs=runs)), None
    n_el = n * int(sum(dims))
    return Row("single", kernel, name, f"({n}, {n_el // n}) G={len(dims)}",
               grouped_work(n_el), make, reps=20)


def _edge_row(graph, d, label, reps=20):
    def make(dev):
        from repro_torch.kernels import ops
        table, valid = graph.neighbor_table
        vals = torch.randn((graph.n, d), generator=_gen(dev, 7), device=dev)
        tab = torch.from_numpy(table).to(dev)
        val = torch.from_numpy(valid).to(dev)
        adj = torch.as_tensor(graph.adjacency, device=dev).contiguous()
        return ((lambda: ops.edge_gather_mix(vals, tab, val)),
                (lambda: torch.matmul(adj, vals)))
    return Row("single", "B6", "edge_gather_mix", label, edge_work(graph, d),
               make, library="torch.matmul (dense adjacency)", reps=reps)


def _paged_row(kernel, name, shape, ctx, online, pool_dtype, label):
    def make(dev):
        import torch.nn.functional as F

        from repro_torch.kernels.paged_attention import paged_attention_cuda
        bsz, heads, num_kv, hd, ps, pps = shape
        g = _gen(dev, 50)
        num_pages = bsz * pps + 3
        q = torch.randn((bsz, heads, hd), generator=g, device=dev)
        pool = (num_pages, ps, num_kv, hd)
        k = torch.randn(pool, generator=g, device=dev).to(pool_dtype)
        v = (2.0 * torch.randn(pool, generator=g, device=dev)).to(pool_dtype)
        bt = torch.randperm(num_pages, generator=g, device=dev)[:bsz * pps]
        bt = bt.reshape(bsz, pps).to(torch.int32).contiguous()
        lens = torch.tensor(ctx, dtype=torch.int32, device=dev)

        def gather(p):
            x = p[bt.long()].reshape(bsz, pps * ps, num_kv, hd)
            return x.permute(0, 2, 1, 3).contiguous()

        kg, vg = gather(k), gather(v)
        qb = q.to(pool_dtype)[:, :, None, :]
        mask = (torch.arange(pps * ps, device=dev)[None]
                < lens[:, None])[:, None, None, :]
        return ((lambda: paged_attention_cuda(q, k, v, bt, lens,
                                              online=online)),
                (lambda: F.scaled_dot_product_attention(
                    qb, kg, vg, attn_mask=mask, enable_gqa=True)))
    pool_bytes = torch.tensor([], dtype=pool_dtype).element_size()
    return Row("single", kernel, name, label,
               paged_work(shape, ctx, 32, online, pool_bytes), make,
               library="SDPA over gathered K/V", reps=50)


def _slstm_row(b, s, wx_dtype, state, label):
    dims = (b, s, SLSTM_H, SLSTM_DH)

    def make(dev):
        from repro_torch.kernels.slstm_cell import slstm_cell_cuda
        h, dh = SLSTM_H, SLSTM_DH
        g = _gen(dev, 99)
        wx = (0.5 * torch.randn((b, s, h, 4 * dh), generator=g,
                                device=dev)).to(wx_dtype)
        r_w = torch.randn((h, dh, 4 * dh), generator=g,
                          device=dev) / dh ** 0.5
        fb = torch.full((h, dh), 3.0, device=dev)
        zero = torch.zeros((b, h, dh), device=dev)
        m0 = torch.full_like(zero, -1e30) if state == "fresh" \
            else zero.clone()
        args = (wx, r_w, fb, zero, zero.clone(), m0, zero.clone())
        return (lambda: slstm_cell_cuda(*args)), None
    wx_bytes = torch.tensor([], dtype=wx_dtype).element_size()
    return Row("single", "B9", "slstm_cell", label,
               slstm_work(dims, wx_bytes), make, reps=5 if s > 100 else 50)


def rows() -> List[Row]:
    """Every row of the table, ``single`` then ``multi``."""
    from repro_torch.core import graph as G
    from repro_torch.runtime import steps as ST

    dims = lm_leaf_dims()
    lm_dim = int(sum(dims))
    bf16, f32 = torch.bfloat16, torch.float32
    out = [
        _quant_row(64, 2000),
        _mix_row("single", "(64, 64) x (64, 2000)", 64, 64, 2000, 100),
        _mix_row("single", "(1024, 1024) x (1024, 2000)", 1024, 1024, 2000,
                 100),
        _mix_row("single", f"LM (4, 4) x (4, {lm_dim})", 4, 4, lm_dim, 20),
        _grouped_row("B3", "stoch_quantize_grouped_fused", dims, 4),
        _grouped_row("B4", "stoch_quantize_grouped_fused_tiled", dims, 4),
        _grouped_row("B5", "stoch_quantize_grouped", dims, 4),
        _edge_row(ST.worker_graph(4), lm_dim, f"LM (4, {lm_dim}) S=2"),
        _edge_row(G.star_graph(257), 2000, "star_graph(257) d=2000",
                  reps=100),
        _paged_row("B7", "paged_attention_decode", (8, 32, 4, 64, 16, 64),
                   stream_ctx(), False, bf16,
                   "stream (8, 32, 4, 64) P=64 bf16 pools"),
        _paged_row("B7", "paged_attention_decode", (8, 32, 4, 64, 16, 84),
                   load_ctx(), False, f32,
                   "load (8, 32, 4, 64) P=84 float32 pools"),
        _paged_row("B8", "paged_attention_decode_online",
                   (8, 32, 4, 64, 16, 256), long_ctx(), True, bf16,
                   f"{LONG_PROMPT} + {LONG_NEW} request P=256 bf16 pools"),
        _slstm_row(1, 64, bf16, "admitted", "paged chunk (1, 64) bf16"),
        _slstm_row(8, 700, bf16, "fresh", "lockstep prefill (8, 700) bf16"),
    ]
    out += [_mix_row("multi", label, m, n, d, 100)
            for label, (m, n, d) in ROW_BLOCKS.items()]
    return out


# ------------------------------------------------------------ the card --
def time_ms(fn: Callable[[], object], reps: int, rounds: int = 5) -> float:
    """One call's device time: CUDA events around ``reps`` back-to-back
    calls, over the count; the median of ``rounds`` runs."""
    fn()
    torch.cuda.synchronize()
    per_call = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        per_call.append(start.elapsed_time(end) / reps)
    return statistics.median(per_call)


def card_name() -> str:
    """The card's name and power limit as ``nvidia-smi`` prints them."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], check=True, capture_output=True,
            text=True, timeout=60).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError) as e:
        return f"unknown ({e})"


def measure(row: Row, dev: Optional[torch.device],
            card: str = "") -> Dict:
    """The row's record: bytes, operations and bound always; on the card
    its time, share, library time and status."""
    b_ms, by = bound(*row.work)
    rec = {"kernel": row.kernel, "name": row.name, "shape": row.shape,
           "bytes": row.work[0], "operations": row.work[1],
           "bound_ms": b_ms, "bound_by": by, "library": row.library}
    if dev is None or dev.type != "cuda":
        rec["status"] = "missing"
        return rec
    rec["card"] = card
    try:
        fn, lib = row.make(dev)
        ms = time_ms(fn, row.reps)
        rec.update(ms=ms, share=b_ms / ms,
                   library_ms=time_ms(lib, row.reps) if lib else None)
        rec["status"] = "ok" if rec["share"] <= SHARE_LIMIT else "fail"
    except Exception as e:            # a launch that raises is a failure
        rec.update(status="fail", error=f"{type(e).__name__}: {e}")
    return rec


def _print_table(mesh: str, table: List[Dict], card: str) -> None:
    print(f"# roofline ({mesh}; {card or 'no card'}): kernel,name,shape,"
          f"status,bound_ms,bound_by,ms,share,library_ms")
    for r in table:
        timed = ",".join(f"{r[k]:.5g}" if isinstance(r.get(k), float)
                         else "" for k in ("ms", "share", "library_ms"))
        print(f"{r['kernel']},{r['name']},{r['shape']},{r['status']},"
              f"{r['bound_ms']:.5g},{r['bound_by']},{timed}")


def stage_roofline(ctx=None) -> Record:
    dev = resolve_device(ctx.device if ctx is not None else None)
    card = card_name() if dev.type == "cuda" else ""
    tables: Dict[str, List[Dict]] = {"single": [], "multi": []}
    for row in rows():
        tables[row.mesh].append(measure(row, dev, card))
    fails = 0
    for mesh, table in tables.items():
        _print_table(mesh, table, card)
        fails += sum(r["status"] == "fail" for r in table)
    data = dict(tables, card=card or None, multi_note=MULTI_NOTE,
                peak_bytes_per_s=PEAK_BYTES_PER_S,
                peak_f32_flops=PEAK_F32_FLOPS)
    return Record(
        section=("roofline",), data=data,
        claims=(
            Claim("roofline_no_failed_records", fails == 0,
                  value=fails, gate="0 rows with status=fail (a launch "
                                    "that raises, or share > 1.05)"),),
        claims_path=("roofline", "claims"))
