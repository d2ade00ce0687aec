"""The port's sparse topology backend (``repro_torch.core.topology``)
against the JAX package's sparse backend and the port's dense one, on the
graphs of ``tests/test_topology.py``.

Tolerances and their reasons:

* mix and Laplacian against the JAX sparse backend through its Pallas
  kernel (``use_pallas_mix=True``, interpret mode): bit for bit, both sum
  in slot order from 0.
* against the JAX sparse backend's jnp gather/segment-sum arm and against
  the port's dense backend (``A @ V``): within 1e-6 of the sum of the
  terms' magnitudes, the two sum in other orders.
* the primal residual (Eq. 28): relative 1e-6 to both.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import topology as JT
from repro.core.graph import chain_graph as jchain
from repro.core.graph import membership_graph as jmembership
from repro.core.graph import random_bipartite_graph as jrandom
from repro.core.graph import star_graph as jstar
from repro_torch.core import topology as T
from repro_torch.core.graph import (chain_graph, membership_graph,
                                    random_bipartite_graph, star_graph)

GRAPHS = {
    "random": (lambda: random_bipartite_graph(12, 0.3, seed=7),
               lambda: jrandom(12, 0.3, seed=7)),
    "chain": (lambda: chain_graph(9), lambda: jchain(9)),
    "star": (lambda: star_graph(6), lambda: jstar(6)),
}


def values(n, seed=1, d=20):
    return np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)


def close(got, want, scale):
    np.testing.assert_array_less(np.abs(np.asarray(got) - np.asarray(want)),
                                 1e-6 * scale + 1e-30)


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_sparse_mix_and_laplacian_match_jax_sparse(name):
    g, jg = (f() for f in GRAPHS[name])
    v = values(g.n)
    topo = T.build(g, "sparse", device="cpu")
    assert topo.backend == "sparse" and topo.nbr_table.shape[1] == g.max_degree
    mix = topo.mix(torch.from_numpy(v)).numpy()
    lap = topo.laplacian(torch.from_numpy(v)).numpy()
    pallas = JT.build(jg, "sparse", use_pallas_mix=True)
    np.testing.assert_array_equal(mix, np.asarray(pallas.mix(jnp.asarray(v))))
    np.testing.assert_array_equal(
        lap, np.asarray(pallas.laplacian(jnp.asarray(v))))
    seg = JT.build(jg, "sparse")
    scale = g.adjacency @ np.abs(v)
    close(mix, seg.mix(jnp.asarray(v)), scale)
    close(lap, seg.laplacian(jnp.asarray(v)),
          scale + g.degrees[:, None] * np.abs(v))


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_sparse_matches_the_ports_dense_backend(name):
    g, _ = (f() for f in GRAPHS[name])
    v = torch.from_numpy(values(g.n, seed=2))
    sparse = T.build(g, "sparse", device="cpu")
    dense = T.build(g, "dense", device="cpu")
    scale = g.adjacency @ np.abs(v.numpy())
    close(sparse.mix(v), dense.mix(v), scale)
    close(sparse.laplacian(v), dense.laplacian(v),
          scale + g.degrees[:, None] * np.abs(v.numpy()))
    # a two-leaf tree mixes through the packed buffer, leaf for leaf the
    # same as each leaf alone
    tree = {"a": v[:, :12].reshape(g.n, 3, 4), "b": v[:, 12:]}
    out = sparse.mix(tree)
    torch.testing.assert_close(out["a"].reshape(g.n, 12),
                               sparse.mix(v[:, :12].contiguous()),
                               rtol=0, atol=0)
    torch.testing.assert_close(out["b"], sparse.mix(v[:, 12:].contiguous()),
                               rtol=0, atol=0)


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_primal_and_dual_residuals_match(name):
    g, jg = (f() for f in GRAPHS[name])
    v = values(g.n, seed=3)
    topo = T.build(g, "sparse", device="cpu")
    got = float(topo.primal_residual(torch.from_numpy(v)))
    want = float(JT.build(jg, "sparse").primal_residual(jnp.asarray(v)))
    dense = float(T.build(g, "dense", device="cpu").primal_residual(
        torch.from_numpy(v)))
    assert got == pytest.approx(want, rel=1e-6)
    assert got == pytest.approx(dense, rel=1e-6)
    lap = topo.laplacian(torch.from_numpy(v))
    jlap = JT.build(jg, "sparse", use_pallas_mix=True).laplacian(
        jnp.asarray(v))
    assert float(topo.dual_residual(lap)) == pytest.approx(
        float(JT.build(jg, "sparse").dual_residual(jlap)), rel=1e-6)


def test_rebuild_keeps_the_backend_for_a_new_graph():
    g0 = membership_graph(8, 0.4, seed=0, epoch=0)
    g1 = membership_graph(5, 0.4, seed=0, epoch=1)
    for backend in ("dense", "sparse"):
        topo = T.build(g0, backend, device="cpu")
        new = topo.rebuild(g1)
        assert type(new) is type(topo) and new.n == 5
        assert new.degrees.device == topo.degrees.device
        v = torch.from_numpy(values(5, seed=4))
        close(new.mix(v), g1.adjacency @ v.numpy(),
              g1.adjacency @ np.abs(v.numpy()))
    sparse = T.build(g0, "sparse", device="cpu").rebuild(g1)
    table, valid = g1.neighbor_table
    np.testing.assert_array_equal(sparse.nbr_table.numpy(), table)
    np.testing.assert_array_equal(sparse.nbr_valid.numpy(), valid)
    np.testing.assert_array_equal(
        np.stack([sparse.und_head.numpy(), sparse.und_tail.numpy()], 1),
        g1.edges)


def test_sharded_backend_still_refused():
    """The sharded backend builds (it was refused before it was ported):
    with no process group a world of one, mixing as the dense backend does,
    and it rebuilds as itself; an unknown backend is still refused."""
    topo = T.build(chain_graph(4), "sharded", device="cpu")
    assert type(topo) is T.ShardedTopology and topo.world == 1
    v = torch.from_numpy(values(4, seed=4))
    torch.testing.assert_close(
        topo.mix(v), T.build(chain_graph(4), "dense", device="cpu").mix(v),
        rtol=0, atol=0)
    new = topo.rebuild(chain_graph(6))
    assert type(new) is T.ShardedTopology and new.n == 6
    with pytest.raises(ValueError):
        T.build(chain_graph(4), "ring", device="cpu")


def test_graph_metadata_matches_the_jax_package():
    """The port's copy of ``core/graph.py``: the sparse backend's CSR and
    edge views, the neighbor table and the signed incidence, array for
    array, and ``membership_graph`` draw for draw."""
    pairs = [(f(), jf()) for f, jf in GRAPHS.values()]
    pairs += [(membership_graph(n, p, seed=s, epoch=e),
               jmembership(n, p, seed=s, epoch=e))
              for n, p, s, e in ((8, 0.4, 0, 0), (5, 0.4, 0, 3),
                                 (2, 0.4, 1, 9), (64, 0.35, 2, 1))]
    for g, jg in pairs:
        for attr in ("edges", "head_mask", "adjacency", "degrees",
                     "edge_src", "edge_dst", "csr_offsets", "csr_indices",
                     "signed_incidence"):
            np.testing.assert_array_equal(getattr(g, attr),
                                          np.asarray(getattr(jg, attr)),
                                          err_msg=attr)
        for a, b in zip(g.neighbor_table, jg.neighbor_table):
            np.testing.assert_array_equal(a, np.asarray(b))
        assert g.max_degree == jg.max_degree
