"""Launch wrapper of the CUDA ``edge_gather_mix`` kernels
(csrc/edge_gather_mix.cu): a staged design (V's column tile for all N rows
in shared memory) and a gather design for N too large to stage. ``plan``
picks one, with its geometry, from the shapes; the C launcher takes the
plan as it is.

The port's counterpart of ``repro.kernels.edge_gather_mix.edge_gather_mix``.
It takes CUDA tensors only; ``kernels.ops.edge_gather_mix`` is the entry
point the sparse topology calls. The table's ids are not checked here (that
would read the table back to the host every call): the kernels clamp them
into [0, N). The host path is kept thin, as B2's: the C function is
resolved once, one combined check guards memory, the plan is cached, and
the stream is read as a raw handle.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels import build

THREADS = 256
SMS = 132                    # H100 SXM
SM_SMEM = 233_472            # shared memory of an SM, bytes
BLOCK_SMEM = 232_448         # the most one block may take
BLOCK_RESERVED = 1_024       # the card's own share of each block's
STAGE_CAP = 64 * 1024        # the staged design's V tile, at most
TWO_PER_SM = SM_SMEM // 2 - BLOCK_RESERVED   # a block that leaves room for 2
TARGET_BLOCKS = 2 * SMS      # grow row groups only while this many remain
STAGES = 4                   # the staged ring (kStages)
LOOP_AT = 32 * SMS           # more tiles than this: a grid-stride loop
GATHER_ROWS, GATHER_TILE, GATHER_RING = 8, 32, 8
GATHER_CHUNK = 512           # slots staged at a time by the gather design

_F32, _I32 = torch.float32, torch.int32
_launch = None


class Plan(NamedTuple):
    """What the launcher runs: ``regime`` "staged" or "gather"; ``vec``
    float4 units (else float); ``cols`` units per row; ``tile`` units of
    columns (a power of two) and ``rows`` output rows per block; ``chunk``
    slots staged at a time (gather; S when staged); ``grid`` (x, y);
    ``smem`` bytes."""
    regime: str
    vec: bool
    cols: int
    tile: int
    rows: int
    chunk: int
    grid: Tuple[int, int]
    smem: int


def _pow2_at_least(x: int) -> int:
    return 1 << max(0, (x - 1).bit_length())


def _per_sm(smem: int) -> int:
    """Resident blocks of 256 threads an SM holds at this footprint."""
    return max(1, min(2048 // THREADS, SM_SMEM // (smem + BLOCK_RESERVED)))


def slot_bytes(rows: int, s: int) -> int:
    """Staged ids and weights of ``rows`` table rows, each array 16-byte
    aligned."""
    return 2 * (-(-(4 * rows * s) // 16) * 16)


@functools.lru_cache(maxsize=256)
def plan(n: int, s: int, d: int, aligned: bool,
         regime: Optional[str] = None) -> Plan:
    """The regime and geometry for values (n, d), a table (n, s), and V's
    rows 16-byte ``aligned`` or not. Pure: the CPU tests check it.
    ``regime`` forces "staged" or "gather" (the card tests and timings hold
    both designs to one shape); the entry point never passes it.

    Staged while a column tile of ``tile`` units for all n rows fits
    ``STAGE_CAP``: the tile starts at 256 / min(8, n) units (a row pass of
    256 threads covers min(8, n) rows), no wider than the row, and halves
    down to 4 units (or the row's width) until it fits. Row groups start at
    one pass and double while the grid keeps ``TARGET_BLOCKS`` blocks (V is
    staged once per row group) and a block, its rows' slots with it, leaves
    room for a second on its SM. Past ``LOOP_AT`` tiles a block loops over
    column tiles (one wave) through the ``STAGES`` ring. Otherwise the
    gather design: 8 rows a block, 32 units of columns, slots staged
    ``GATHER_CHUNK`` at a time."""
    vec = aligned and d % 4 == 0
    unit = 16 if vec else 4
    cols = d // 4 if vec else d
    width = _pow2_at_least(max(cols, 1))
    tile = min(THREADS // min(8, _pow2_at_least(max(n, 1))), width)
    while tile > min(4, width) and n * tile * unit > STAGE_CAP:
        tile //= 2
    v_bytes = n * tile * unit
    rows = min(THREADS // tile, n)
    while rows > 1 and slot_bytes(rows, s) + v_bytes > BLOCK_SMEM:
        rows //= 2                           # a very wide table
    stageable = (v_bytes <= STAGE_CAP
                 and slot_bytes(rows, s) + v_bytes <= BLOCK_SMEM)
    if regime == "staged" and not stageable:
        raise ValueError(f"edge_gather_mix: ({n}, {d}) with {s} slots does "
                         f"not fit the staged design")
    if stageable and regime != "gather":
        col_tiles = -(-cols // tile)
        while (rows < n and col_tiles * -(-n // (2 * rows)) >= TARGET_BLOCKS
               and slot_bytes(2 * rows, s) + v_bytes <= TWO_PER_SM):
            rows *= 2
        groups = -(-n // rows)
        gx = col_tiles
        if col_tiles * groups > LOOP_AT:
            one = slot_bytes(rows, s) + STAGES * v_bytes
            if one <= BLOCK_SMEM:
                gx = min(col_tiles, max(1, SMS * _per_sm(one) // groups))
        stages = min(STAGES, -(-col_tiles // gx))
        return Plan("staged", vec, cols, tile, rows, s, (gx, groups),
                    slot_bytes(rows, s) + stages * v_bytes)
    chunk = max(1, min(s, GATHER_CHUNK))
    smem = GATHER_ROWS * chunk * 8 + GATHER_RING * THREADS * unit
    col_tiles = -(-cols // GATHER_TILE)
    return Plan("gather", vec, cols, GATHER_TILE, GATHER_ROWS, chunk,
                (-(-n // GATHER_ROWS), min(col_tiles, 65535)), smem)


class _CPlan(ctypes.Structure):
    """``EdgePlan`` of csrc/edge_gather_mix.cu, field for field."""
    _fields_ = [("cols", ctypes.c_longlong)] + [
        (f, ctypes.c_int) for f in ("n", "s", "vec", "gather", "tile", "rows",
                                    "chunk", "grid_x", "grid_y", "smem")]


def c_plan(n: int, s: int, p: Plan) -> _CPlan:
    """Plan ``p`` for an (n, ·) V and an (n, s) table, as the launcher
    takes it."""
    return _CPlan(p.cols, n, s, p.vec, p.regime == "gather", p.tile, p.rows,
                  p.chunk, p.grid[0], p.grid[1], p.smem)


@functools.lru_cache(maxsize=256)
def _planned(n: int, s: int, d: int, aligned: bool) -> Tuple[_CPlan, int]:
    """``plan``'s C struct and its address, kept alive by the cache."""
    cp = c_plan(n, s, plan(n, s, d, aligned))
    return cp, ctypes.addressof(cp)


def _lib() -> ctypes.CDLL:
    """The loaded library, its entry's argument types set."""
    global _launch
    lib = build.load("edge_gather_mix")
    if _launch is None:
        fn = lib.edge_gather_mix_f32
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 6
        _launch = fn
    return lib


def launch(values: torch.Tensor, nbr_table: torch.Tensor,
           nbr_valid: torch.Tensor, out: torch.Tensor, p: Plan) -> None:
    """Run plan ``p`` on checked tensors (``edge_gather_mix_cuda`` does
    the checks; the card tests call this to hold both regimes to the plain
    version at one shape)."""
    if _launch is None:
        _lib()
    cp = c_plan(values.shape[0], nbr_table.shape[1], p)
    _check(_launch(values.data_ptr(), nbr_table.data_ptr(),
                   nbr_valid.data_ptr(), out.data_ptr(), ctypes.addressof(cp),
                   torch._C._cuda_getCurrentRawStream(values.get_device())))


def _check(err: int) -> None:
    if err != 0:
        raise RuntimeError(f"edge_gather_mix launch failed: CUDA error {err}")


def edge_gather_mix_cuda(values: torch.Tensor, nbr_table: torch.Tensor,
                         nbr_valid: torch.Tensor) -> torch.Tensor:
    """``out[n] = sum_s valid[n, s] * values[nbr[n, s]]`` on the current
    stream: values (N, d) float32, nbr_table (N, S) int32, nbr_valid (N, S)
    float32, all contiguous on one card -> (N, d) float32. Same contract as
    ``ref.edge_gather_mix_ref``, bit for bit."""
    dev = values.get_device()
    if not (values.is_cuda and values.dim() == 2 and nbr_table.dim() == 2
            and values.dtype == _F32 and nbr_table.dtype == _I32
            and nbr_valid.dtype == _F32
            and nbr_valid.shape == nbr_table.shape
            and nbr_table.shape[0] == values.shape[0]
            and nbr_table.get_device() == dev
            and nbr_valid.get_device() == dev
            and values.is_contiguous() and nbr_table.is_contiguous()
            and nbr_valid.is_contiguous()):
        raise ValueError(
            f"edge_gather_mix: needs contiguous CUDA float32 (N, d) values, "
            f"int32 (N, S) table and float32 (N, S) validity on one device, "
            f"got {tuple(values.shape)} {values.dtype} on {values.device}, "
            f"{tuple(nbr_table.shape)} {nbr_table.dtype} on "
            f"{nbr_table.device}, {tuple(nbr_valid.shape)} "
            f"{nbr_valid.dtype} on {nbr_valid.device}")
    if _launch is None:
        _lib()
    n, d = values.shape
    vp = values.data_ptr()
    out = torch.empty_like(values)
    _check(_launch(vp, nbr_table.data_ptr(), nbr_valid.data_ptr(),
                   out.data_ptr(),
                   _planned(n, nbr_table.shape[1], d, vp % 16 == 0)[1],
                   torch._C._cuda_getCurrentRawStream(dev)))
    return out
