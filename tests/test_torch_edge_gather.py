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
