"""The port's numpy copies of the graph, data and communication-accounting
modules give the JAX package's arrays, bit for bit, from the same seed."""
import numpy as np
import pytest

from repro.core import comm as jcomm
from repro.core import graph as jgraph
from repro.data import regression as jdata
from repro_torch.core import comm
from repro_torch.core import graph
from repro_torch.data import regression as data

GRAPH_FIELDS = ("edges", "head_mask", "adjacency", "degrees")


def assert_same_graph(g, jg):
    assert g.n == jg.n
    for f in GRAPH_FIELDS:
        a, b = getattr(g, f), getattr(jg, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    np.testing.assert_array_equal(g.edge_src, jg.edge_src)
    np.testing.assert_array_equal(g.edge_dst, jg.edge_dst)


@pytest.mark.parametrize("n,p,seed", [(24, 0.35, 0), (24, 0.35, 3),
                                      (64, 0.35, 0), (10, 1.0, 1),
                                      (7, 0.2, 5)])
def test_random_bipartite_graph_matches_jax(n, p, seed):
    g = graph.random_bipartite_graph(n, p, seed=seed)
    assert_same_graph(g, jgraph.random_bipartite_graph(n, p, seed=seed))
    g.validate()


def test_fixed_graphs_match_jax():
    assert_same_graph(graph.chain_graph(9), jgraph.chain_graph(9))
    assert_same_graph(graph.complete_bipartite_graph(3, 4),
                      jgraph.complete_bipartite_graph(3, 4))
    assert_same_graph(graph.star_graph(6), jgraph.star_graph(6))
    assert graph.is_connected(graph.star_graph(6).adjacency)


@pytest.mark.parametrize("name", ["synth-linear", "synth-logistic",
                                  "bodyfat", "derm"])
def test_datasets_match_jax(name):
    d, jd = data.DATASETS[name](), jdata.DATASETS[name]()
    assert (d.task, d.name) == (jd.task, jd.name)
    for f in ("x", "y"):
        a, b = getattr(d, f), getattr(jd, f)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("n_workers,seed", [(24, 0), (7, 2)])
def test_partition_uniform_matches_jax(n_workers, seed):
    d = data.synth_linear(n=300, d=11, seed=4)
    x, y = data.partition_uniform(d, n_workers, seed=seed)
    jx, jy = jdata.partition_uniform(jdata.synth_linear(n=300, d=11, seed=4),
                                     n_workers, seed=seed)
    assert x.shape == (n_workers, 300 // n_workers, 11)
    np.testing.assert_array_equal(x, jx)
    np.testing.assert_array_equal(y, jy)


@pytest.mark.parametrize("mode,frac", [("fixed", 0.5), ("actual", 0.5),
                                       ("actual", 1.0)])
def test_comm_log_matches_jax(mode, frac):
    g = graph.random_bipartite_graph(12, 0.4, seed=2)
    jg = jgraph.random_bipartite_graph(12, 0.4, seed=2)
    rng = np.random.default_rng(0)
    tx = (rng.uniform(size=(30, 12)) < 0.6).astype(np.float32)
    payload = rng.integers(100, 900, size=(30, 12)).astype(np.float32)
    log = comm.build_comm_log(tx, payload, g, fraction_active=frac,
                              bandwidth_mode=mode)
    jlog = jcomm.build_comm_log(tx, payload, jg, fraction_active=frac,
                                bandwidth_mode=mode)
    for f in ("cumulative_rounds", "cumulative_bits", "cumulative_energy"):
        np.testing.assert_array_equal(getattr(log, f), getattr(jlog, f))
