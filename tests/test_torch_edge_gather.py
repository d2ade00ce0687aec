"""The plain version of the port's ``edge_gather_mix`` (kernel B6,
``repro_torch.kernels.ref.edge_gather_mix_ref``) against the JAX package's
Pallas kernel in interpret mode and its jnp reference.

Tolerances and their reasons:

* against ``repro.kernels.edge_gather_mix.edge_gather_mix(interpret=True)``:
  bit for bit, NaN for NaN. Both accumulate in slot order from 0, the
  product rounded before the add, and multiply padded slots by their 0.0;
  both clamp table ids into [0, N).
* against ``repro.kernels.ref.edge_gather_mix_ref`` (an einsum, whose
  reduction order is XLA's): within 1e-6 x S x max|V|.

Shapes: those of ``chip_smoke.py``'s B6 phase cut to small widths, the
4-worker graph of the LM trainer, N = 2, and tables whose pad slots point
out of range at rows holding NaN and inf.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.edge_gather_mix import edge_gather_mix as jax_kernel
from repro_torch.core import graph as G
from repro_torch.kernels import ops, ref
from repro_torch.runtime import steps as ST

GRAPHS = {
    "6-odd-d": (lambda: G.random_bipartite_graph(6, 0.5, seed=1), 7),
    "paper-24": (lambda: G.random_bipartite_graph(24, 0.35, seed=0), 50),
    "full-64": (lambda: G.random_bipartite_graph(64, 0.35, seed=0), 40),
    "star-257": (lambda: G.star_graph(257), 16),
    "random-1024": (lambda: G.random_bipartite_graph(1024, 0.05, seed=0), 4),
    "lm-4": (lambda: ST.worker_graph(4), 33),
    "pair-2": (lambda: G.complete_bipartite_graph(1, 1), 5),
}


def inputs(g, d, seed):
    table, valid = g.neighbor_table
    vals = np.random.default_rng(seed).standard_normal(
        (g.n, d)).astype(np.float32)
    return vals, table, valid


def run_both(vals, table, valid):
    want = np.asarray(jax_kernel(jnp.asarray(vals), jnp.asarray(table),
                                 jnp.asarray(valid), interpret=True))
    got = ref.edge_gather_mix_ref(torch.from_numpy(vals),
                                  torch.from_numpy(table),
                                  torch.from_numpy(valid)).numpy()
    return got, want


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_plain_matches_pallas_interpret_bitwise(name):
    make, d = GRAPHS[name]
    g = make()
    vals, table, valid = inputs(g, d, len(name))
    got, want = run_both(vals, table, valid)
    assert got.dtype == np.float32 and got.shape == (g.n, d)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_plain_matches_jax_ref(name):
    make, d = GRAPHS[name]
    g = make()
    vals, table, valid = inputs(g, d, 7)
    got = ref.edge_gather_mix_ref(torch.from_numpy(vals),
                                  torch.from_numpy(table),
                                  torch.from_numpy(valid)).numpy()
    want = np.asarray(jref.edge_gather_mix_ref(
        jnp.asarray(vals), jnp.asarray(table), jnp.asarray(valid)))
    tol = 1e-6 * table.shape[1] * np.abs(vals).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)
    # and it is the neighbor sum A @ V
    np.testing.assert_allclose(got, g.adjacency @ vals, rtol=0, atol=tol)


def poisoned(seed):
    """A 6-worker table whose pad slots point out of range (both ends),
    with NaN and inf in the rows those ids clamp to."""
    g = G.random_bipartite_graph(6, 0.5, seed=1)
    table, valid = (x.copy() for x in g.neighbor_table)
    pads = valid == 0
    assert pads.sum() >= 2
    table[pads] = np.resize(np.array([7, -3, 100, -1], np.int32),
                            int(pads.sum()))
    vals = np.random.default_rng(seed).standard_normal(
        (6, 9)).astype(np.float32)
    vals[0, 2] = np.nan
    vals[5, 1] = np.inf
    return vals, table, valid


def test_out_of_range_pad_ids_match_pallas_interpret():
    vals, table, valid = poisoned(3)
    got, want = run_both(vals, table, valid)
    np.testing.assert_array_equal(got, want)
    # a padded slot multiplies its (clamped) row by 0.0: NaN and inf reach
    # the rows that pad into them
    assert np.isnan(got).any()


def test_ops_on_cpu_is_the_plain_version_and_counts_nothing():
    vals, table, valid = inputs(G.star_graph(9), 6, 1)
    before = dict(ops.launches)
    got = ops.edge_gather_mix(torch.from_numpy(vals).double(),
                              torch.from_numpy(table),
                              torch.from_numpy(valid))
    want = ref.edge_gather_mix_ref(torch.from_numpy(vals),
                                   torch.from_numpy(table),
                                   torch.from_numpy(valid))
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert ops.launches == before


# ------------------------------------------- the CUDA kernel's plan, modelled
# ``edge_gather_mix.plan`` decides the regime and geometry the C launcher
# runs; these tests check the plan at the card's shapes and model both
# designs' walks in numpy float32 (tile copy, clamped ids, slot-order
# product-then-add), bit for bit against the plain version and the Pallas
# kernel in interpret mode.
from repro_torch.kernels import edge_gather_mix as EG  # noqa: E402

# chip_smoke.py's edge_cases(): (graph, d)
CARD_SHAPES = {
    "(6, 7)": (lambda: G.random_bipartite_graph(6, 0.5, seed=1), 7),
    "paper (24, 50)": (lambda: G.random_bipartite_graph(24, 0.35, seed=0),
                       50),
    "full (64, 2000)": (lambda: G.random_bipartite_graph(64, 0.35, seed=0),
                        2000),
    "star_graph(257)": (lambda: G.star_graph(257), 2000),
    "random(1024, 0.05)": (
        lambda: G.random_bipartite_graph(1024, 0.05, seed=0), 2000),
    "lm (4, 134277912)": (lambda: ST.worker_graph(4), 134277912),
}
CARD_REGIMES = {"(6, 7)": "staged", "paper (24, 50)": "staged",
                "full (64, 2000)": "staged", "star_graph(257)": "staged",
                "random(1024, 0.05)": "staged", "lm (4, 134277912)": "staged"}


def check_plan(p, n, s, d, aligned):
    """What every plan must satisfy: shared memory within a block's 227
    KB, units that tile the row, and a grid whose blocks take every (row
    group, column tile) once."""
    assert 0 < p.smem <= EG.BLOCK_SMEM
    assert p.vec == (aligned and d % 4 == 0)
    assert p.cols * (4 if p.vec else 1) == d
    assert p.tile & (p.tile - 1) == 0 and p.tile <= EG.THREADS
    gx, gy = p.grid
    assert 1 <= gy <= 65535 and gx >= 1
    if p.regime == "staged":
        col_tiles = -(-p.cols // p.tile)
        assert gy == -(-n // p.rows) and gx <= col_tiles
        stages = min(EG.STAGES, -(-col_tiles // gx))
        assert p.chunk == s
        assert p.smem == (EG.slot_bytes(p.rows, s)
                          + stages * n * p.tile * (16 if p.vec else 4))
    else:
        assert (p.tile, p.rows) == (EG.GATHER_TILE, EG.GATHER_ROWS)
        assert gx == -(-n // EG.GATHER_ROWS)
        assert 1 <= p.chunk <= max(1, min(s, EG.GATHER_CHUNK))
        assert p.smem == (8 * 8 * p.chunk
                          + 8 * EG.THREADS * (16 if p.vec else 4))


@pytest.mark.parametrize("name", sorted(CARD_SHAPES))
def test_plan_at_the_card_shapes(name):
    make, d = CARD_SHAPES[name]
    g = make()
    s = g.neighbor_table[0].shape[1]
    for aligned in (True, False):
        p = EG.plan(g.n, s, d, aligned)
        check_plan(p, g.n, s, d, aligned)
        assert p.regime == CARD_REGIMES[name]
    p = EG.plan(g.n, s, d, True)
    # the block count fills the card where the work allows it
    gx, gy = p.grid
    if g.n * p.cols >= 64 * EG.SMS * EG.THREADS:
        assert gx * gy >= EG.SMS
    if name.startswith("lm"):       # N = 4: V read once, one row group
        assert gy == 1 and p.rows == 4 and gx < -(-p.cols // p.tile)


# the switch: the staged V tile n x 4 units fits STAGE_CAP up to n_switch
SWITCHES = {"float4 d=2000": (2000, True, EG.STAGE_CAP // (4 * 16)),
            "float d=50": (50, True, EG.STAGE_CAP // (4 * 4)),
            "unaligned d=2000": (2000, False, EG.STAGE_CAP // (4 * 4)),
            "float d=2": (2, True, EG.STAGE_CAP // (2 * 4))}


@pytest.mark.parametrize("name", sorted(SWITCHES))
@pytest.mark.parametrize("step", [-1, 0, 1])
def test_plan_regime_switch(name, step):
    d, aligned, n_switch = SWITCHES[name]
    n = n_switch + step
    p = EG.plan(n, 72, d, aligned)
    check_plan(p, n, 72, d, aligned)
    assert p.regime == ("staged" if step <= 0 else "gather")


def test_plan_lifts_the_worker_limit():
    """Past 65,535 workers (the first design's gridDim.y): row groups of
    the gather design go in gridDim.x."""
    for n, s, d in ((70000, 3, 3), (1 << 20, 8, 64), (2 ** 31 - 1, 1, 1)):
        p = EG.plan(n, s, d, True)
        check_plan(p, n, s, d, True)
        assert p.regime == "gather" and p.grid[0] == -(-n // 8)


def staged_threads(p):
    """The staged kernel's thread map: each thread's tile unit, its first
    row in a pass, and the rows a pass covers."""
    tid = np.arange(EG.THREADS)
    return tid % p.tile, tid // p.tile, EG.THREADS // p.tile


def kernel_model(vals, table, valid, p):
    """The CUDA kernels' walk under plan ``p``, in numpy float32: each
    block copies its column tile of V (all N rows when staged), clamps its
    rows' ids, and each output unit sums w * v in slot order from 0 (the
    product rounded before the add). Returns out and the count of writes
    of each output unit (threads enumerated as the kernels map them)."""
    n, d = vals.shape
    s = table.shape[1]
    unit = 4 if p.vec else 1
    v_u = vals.reshape(n, p.cols, unit)
    out = np.full((n, p.cols, unit), np.nan, np.float32)
    writes = np.zeros((n, p.cols), np.int64)
    ids = np.clip(table, 0, n - 1)
    gx, gy = p.grid
    tid = np.arange(EG.THREADS)
    if p.regime == "staged":
        col_tiles = -(-p.cols // p.tile)
        cc, rr, pass_ = staged_threads(p)
        rows = [(by * p.rows, min(p.rows, n - by * p.rows))
                for by in range(gy)]
        tiles = [(bx, t) for bx in range(gx)
                 for t in range(bx, col_tiles, gx)]
    else:
        col_tiles = -(-p.cols // EG.GATHER_TILE)
        cc, rr = tid % 32, tid // 32
        rows = [(bx * 8, min(8, n - bx * 8)) for bx in range(gx)]
        tiles = [(by, t) for by in range(gy)
                 for t in range(by, col_tiles, gy)]
        pass_ = 8
    for r0, nr in rows:
        for _, t in tiles:
            c = t * p.tile + cc
            for r in range(nr):
                lanes = (rr <= r) & ((r - rr) % pass_ == 0) & (c < p.cols)
                cols = c[lanes]
                tile_v = v_u[:, cols]        # the staged or gathered units
                acc = np.zeros((cols.size, unit), np.float32)
                with np.errstate(invalid="ignore"):   # 0 x inf is NaN
                    for j in range(s):
                        acc = acc + valid[r0 + r, j] * tile_v[ids[r0 + r, j]]
                out[r0 + r, cols] = acc
                np.add.at(writes[r0 + r], cols, 1)
    return out.reshape(n, d), writes


def model_cases():
    """(name, vals, table, valid): a poisoned table (pad ids out of range
    at both ends, NaN and inf in the rows they clamp to), d = 7, a row
    with every slot padded, and the star's 256 padded slots."""
    vals, table, valid = poisoned(5)
    cases = [("poisoned d=9", vals, table, valid)]
    g = G.random_bipartite_graph(6, 0.5, seed=1)
    cases.append(("d=7", *inputs(g, 7, 2)))
    vals, table, valid = inputs(G.random_bipartite_graph(12, 0.4, seed=3),
                                8, 4)
    valid = valid.copy()
    valid[5] = 0.0                     # every slot of row 5 padded
    table = table.copy()
    table[5] = np.arange(table.shape[1]) * 5 - 7
    cases.append(("all-padded row", vals, table, valid))
    cases.append(("star-33", *inputs(G.star_graph(33), 12, 6)))
    return cases


MODEL_PLANS = {
    "plan": None,                      # what plan() picks
    "gather": lambda n, s, d, vec: EG.Plan(
        "gather", vec, d // 4 if vec else d, 32, 8, max(1, min(s, 3)),
        (-(-n // 8), 1), 0),
    "staged-loop": lambda n, s, d, vec: EG.Plan(
        "staged", vec, d // 4 if vec else d, 1, 3, s, (2, -(-n // 3)), 0),
}


@pytest.mark.parametrize("regime", sorted(MODEL_PLANS))
@pytest.mark.parametrize("case", range(4))
def test_kernel_model_matches_plain_and_pallas_bitwise(regime, case):
    name, vals, table, valid = model_cases()[case]
    n, d = vals.shape
    s = table.shape[1]
    make = MODEL_PLANS[regime]
    vec = d % 4 == 0
    p = EG.plan(n, s, d, True) if make is None else make(n, s, d, vec)
    got, writes = kernel_model(vals, table, valid, p)
    assert (writes == 1).all(), name
    want_plain, want_pallas = run_both(vals, table, valid)
    np.testing.assert_array_equal(got, want_plain)
    np.testing.assert_array_equal(got, want_pallas)
    if name.startswith("poisoned"):
        assert np.isnan(got).any()


@pytest.mark.parametrize("n,s,d,aligned", [
    (6, 3, 7, True), (24, 11, 50, True), (64, 27, 200, True),
    (257, 256, 20, True), (40, 5, 4096 + 4, False), (1100, 6, 12, True),
    (4, 2, 4 * 64 * 4300, True)])
def test_plan_grid_covers_every_output_once(n, s, d, aligned):
    """The plan's grid, enumerated with the kernels' thread map, writes
    every output unit exactly once (the last one a grid-stride loop)."""
    p = EG.plan(n, s, d, aligned)
    check_plan(p, n, s, d, aligned)
    gx, gy = p.grid
    tid = np.arange(EG.THREADS)
    writes = np.zeros((n, p.cols), np.int64)
    if p.regime == "staged":
        col_tiles = -(-p.cols // p.tile)
        cc, rr, pass_ = staged_threads(p)
        for by in range(gy):
            r0, nr = by * p.rows, min(p.rows, n - by * p.rows)
            for bx in range(gx):
                for t in range(bx, col_tiles, gx):
                    c = t * p.tile + cc
                    for k in range(-(-nr // pass_)):
                        r = rr + k * pass_
                        ok = (r < nr) & (c < p.cols)
                        np.add.at(writes, (r0 + r[ok], c[ok]), 1)
    else:
        col_tiles = -(-p.cols // 32)
        for bx in range(gx):
            r = bx * 8 + tid // 32
            for by in range(gy):
                for t in range(by, col_tiles, gy):
                    c = t * 32 + tid % 32
                    ok = (r < n) & (c < p.cols)
                    np.add.at(writes, (r[ok], c[ok]), 1)
    assert (writes == 1).all()
