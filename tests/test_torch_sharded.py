"""The port's sharded topology backend (``repro_torch.core.topology``) at
world size 1, in one process: against the JAX package's sharded backend on
its 1-wide mesh and against the port's dense backend. Several ranks:
``test_torch_sharded_ranks.py``.

Tolerances and their reasons:

* mix and Laplacian against the JAX sharded backend, through its Pallas
  kernel on the row block (``use_pallas_mix=True``, interpret mode) and
  through its jitted row-block product: within 1e-6 of the sum of the
  terms' magnitudes (the plain product and the kernel sum in other
  orders). Against the port's dense backend: bit for bit (a world of one
  multiplies the same operands, with or without the all-gather).
* bf16 values: the plain mix equals the JAX sharded Pallas route bit for
  bit while N fits one 128-row k block (``test_torch_hat_dtype.py``'s
  reason: both store the float32 sum rounded once).
* the primal and dual residuals: relative 1e-6 to the JAX package's, and
  equal to the port's dense backend.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.core import graph as JG
from repro.core import topology as JT
from repro.core.solvers import LinearRegressionProblem as JLinear
from repro_torch.core import engine as E
from repro_torch.core import graph as G
from repro_torch.core import solvers
from repro_torch.core import topology as T
from repro_torch.runtime import steps as ST
from test_torch_cuda import assert_mix_close
from test_torch_hat_dtype import to_jax

GRAPHS = {
    "random": (lambda: G.random_bipartite_graph(12, 0.3, seed=7),
               lambda: JG.random_bipartite_graph(12, 0.3, seed=7)),
    "chain": (lambda: G.chain_graph(9), lambda: JG.chain_graph(9)),
    "star": (lambda: G.star_graph(6), lambda: JG.star_graph(6)),
}


def values(n, seed=1, d=20):
    return np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)


@pytest.fixture
def group_of_one(tmp_path):
    """A gloo process group of one over a file store, ended after the
    test."""
    dist.init_process_group("gloo", init_method="file://" + str(
        tmp_path / "store"), rank=0, world_size=1)
    try:
        yield dist.group.WORLD
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_sharded_mix_laplacian_and_residuals_match_jax(name):
    g, jg = (f() for f in GRAPHS[name])
    v = values(g.n)
    topo = T.build(g, "sharded", device="cpu")
    assert (topo.backend, topo.world, topo.rank, topo.row0) == (
        "sharded", 1, 0, 0) and topo.group is None
    assert topo.adjacency.shape == (g.n, g.n)
    jtopo = JT.build(jg, "sharded")
    pallas = JT.build(jg, "sharded", use_pallas_mix=True)
    assert jtopo.mesh.shape["workers"] == 1
    mix = topo.mix(torch.from_numpy(v)).numpy()
    assert_mix_close(mix, pallas.mix(jnp.asarray(v)), g.adjacency, v)
    assert_mix_close(mix, jax.jit(jtopo.mix)(jnp.asarray(v)), g.adjacency, v)
    lap = topo.laplacian(torch.from_numpy(v)).numpy()
    assert_mix_close(lap, pallas.laplacian(jnp.asarray(v)),
                     np.concatenate([g.adjacency, np.diag(g.degrees)], 1),
                     np.concatenate([v, v]))
    dense = T.build(g, "dense", device="cpu")
    np.testing.assert_array_equal(mix, dense.mix(torch.from_numpy(v)))
    np.testing.assert_array_equal(lap, dense.laplacian(torch.from_numpy(v)))
    got = float(topo.primal_residual(torch.from_numpy(v)))
    assert got == pytest.approx(
        float(jtopo.primal_residual(jnp.asarray(v))), rel=1e-6)
    assert got == float(dense.primal_residual(torch.from_numpy(v)))
    dual = float(topo.dual_residual(topo.laplacian(torch.from_numpy(v))))
    assert dual == pytest.approx(float(jtopo.dual_residual(
        pallas.laplacian(jnp.asarray(v)))), rel=1e-6)
    # zero at consensus, as the JAX test asks of every backend
    flat = torch.from_numpy(np.broadcast_to(v[:1], v.shape).copy())
    assert float(topo.dual_residual(topo.laplacian(flat))) < 1e-6


@pytest.mark.parametrize("name", ["random", "chain"])
def test_sharded_tree_mixes_through_the_packed_buffer(name):
    g, jg = (f() for f in GRAPHS[name])
    v = values(g.n, seed=2, d=24)
    topo = T.build(g, "sharded", device="cpu")
    tree = {"a": torch.from_numpy(v[:, :12].reshape(g.n, 3, 4).copy()),
            "b": torch.from_numpy(v[:, 12:].copy())}
    out = topo.mix(tree)
    flat = topo.mix(torch.from_numpy(v))
    np.testing.assert_array_equal(out["a"].reshape(g.n, 12).numpy(),
                                  flat[:, :12].numpy())
    np.testing.assert_array_equal(out["b"].numpy(), flat[:, 12:].numpy())
    jout = JT.build(jg, "sharded", use_pallas_mix=True).mix(
        {"a": jnp.asarray(v[:, :12].reshape(g.n, 3, 4)),
         "b": jnp.asarray(v[:, 12:])})
    assert_mix_close(out["a"].reshape(g.n, 12).numpy(),
                     np.asarray(jout["a"]).reshape(g.n, 12), g.adjacency,
                     v[:, :12])
    # a tree of two dtypes mixes leaf by leaf, each leaf in its own dtype
    mixed = topo.mix({"a": tree["a"], "h": tree["b"].to(torch.bfloat16)})
    assert mixed["h"].dtype == torch.bfloat16
    np.testing.assert_array_equal(mixed["a"].numpy(), out["a"].numpy())


@pytest.mark.parametrize("name", ["random", "chain"])
def test_sharded_bf16_mix_is_the_jax_pallas_route(name):
    g, jg = (f() for f in GRAPHS[name])
    v = torch.from_numpy(3.0 * values(g.n, seed=5, d=40)).to(torch.bfloat16)
    topo = T.build(g, "sharded", device="cpu")
    got = topo.mix(v)
    assert got.dtype == torch.bfloat16
    want = JT.build(jg, "sharded", use_pallas_mix=True).mix(to_jax(v))
    assert want.dtype == jnp.bfloat16
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))
    # the dual update's Laplacian reads the narrowed replica in float32
    lap = topo.laplacian(v)
    assert lap.dtype == torch.float32
    np.testing.assert_array_equal(
        lap.numpy(), T.build(g, "dense", device="cpu").laplacian(v).numpy())


def test_group_of_one_runs_the_all_gather(group_of_one, monkeypatch):
    """Given a process group, a world of one still gathers (one collective
    a mix, two a Laplacian and residual pair) and agrees with the dense
    backend bit for bit."""
    calls = []
    real = T._all_gather

    def counting(out, inp, group=None):
        calls.append(tuple(inp.shape))
        return real(out, inp, group=group)

    monkeypatch.setattr(T, "_all_gather", counting)
    g = G.random_bipartite_graph(12, 0.3, seed=7)
    topo = T.build(g, "sharded", device="cpu")
    assert topo.group is group_of_one and topo.world == 1
    dense = T.build(g, "dense", device="cpu")
    v = torch.from_numpy(values(g.n, seed=3))
    np.testing.assert_array_equal(topo.mix(v).numpy(), dense.mix(v).numpy())
    assert calls == [(12, 20)]
    np.testing.assert_array_equal(topo.laplacian(v).numpy(),
                                  dense.laplacian(v).numpy())
    assert float(topo.primal_residual(v)) == float(dense.primal_residual(v))
    assert float(topo.dual_residual(topo.laplacian(v))) == float(
        dense.dual_residual(dense.laplacian(v)))
    assert len(calls) == 4
    tree = {"w": v.reshape(12, 4, 5), "n": torch.arange(12.0)}
    got = E.gather_workers(tree, topo)
    assert got["w"] is not tree["w"]
    np.testing.assert_array_equal(got["w"].numpy(), tree["w"].numpy())
    np.testing.assert_array_equal(got["n"].numpy(), tree["n"].numpy())
    rebuilt = topo.rebuild(G.random_bipartite_graph(12, 0.3, seed=8))
    assert rebuilt.group is group_of_one and rebuilt.backend == "sharded"


def test_worker_count_must_divide_the_world(monkeypatch):
    monkeypatch.setattr(T, "_group_world", lambda group: (group, 3, 1))
    with pytest.raises(ValueError, match=r"workers \(4\).*size \(3\)"):
        T.build(G.chain_graph(4), "sharded", device="cpu")
    topo = T.build(G.chain_graph(6), "sharded", device="cpu")
    assert (topo.world, topo.rank, topo.row0) == (3, 1, 2)
    assert topo.worker_rows(6) == slice(2, 4)
    np.testing.assert_array_equal(topo.adjacency.numpy(),
                                  G.chain_graph(6).adjacency[2:4])
    np.testing.assert_array_equal(topo.degrees.numpy(),
                                  G.chain_graph(6).degrees[2:4])
    with pytest.raises(ValueError, match="7 workers"):
        topo.worker_rows(7)


def test_group_backend_must_match_the_device(group_of_one, monkeypatch):
    """NCCL carries CUDA tensors, gloo CPU ones; nothing is staged through
    the host, so a CPU run on an NCCL group raises, at build time and at a
    collective."""
    topo = T.build(G.chain_graph(4), "sharded", device="cpu")
    monkeypatch.setattr(dist, "get_backend", lambda group=None: "nccl")
    with pytest.raises(ValueError, match="need a gloo process group"):
        T.build(G.chain_graph(4), "sharded", device="cpu")
    with pytest.raises(ValueError, match="this one is nccl"):
        topo.mix(torch.zeros((4, 3)))
    # a group over both backends names them per device
    monkeypatch.setattr(dist, "get_backend",
                        lambda group=None: "cpu:gloo,cuda:nccl")
    T.build(G.chain_graph(4), "sharded", device="cpu")
    T._check_backend(group_of_one, torch.device("cuda", 0))
    monkeypatch.setattr(dist, "get_backend", lambda group=None: "gloo")
    with pytest.raises(ValueError, match="need a nccl process group"):
        T._check_backend(group_of_one, torch.device("cuda", 0))


def test_pod_pair_graph_matches_jax():
    g, jg = G.pod_pair_graph(), JG.pod_pair_graph()
    for attr in ("edges", "head_mask", "adjacency", "degrees"):
        np.testing.assert_array_equal(getattr(g, attr),
                                      np.asarray(getattr(jg, attr)))
    assert g.n == 2 and g.num_edges == 1
    np.testing.assert_array_equal(ST.worker_graph(2).adjacency, g.adjacency)


def linear_problem(n=8, s=30, d=12):
    rng = np.random.default_rng(4)
    x = rng.standard_normal((n, s, d)).astype(np.float32)
    y = rng.standard_normal((n, s)).astype(np.float32)
    return x, y


def test_take_workers_holds_the_rows():
    x, y = linear_problem()
    whole = solvers.LinearRegressionProblem(torch.from_numpy(x),
                                            torch.from_numpy(y))
    rows = slice(2, 6)
    part = whole.take_workers(rows)
    assert part.n_workers == 4 and part.dim == 12
    for name in ("x", "y", "gram", "xty"):
        np.testing.assert_array_equal(getattr(part, name).numpy(),
                                      getattr(whole, name)[rows].numpy())
    v = torch.from_numpy(values(8, seed=6, d=12))
    rho_d = torch.arange(1.0, 9.0)
    got = part.primal_solve(v[rows], rho_d[rows]).numpy()
    np.testing.assert_array_equal(got,
                                  whole.primal_solve(v, rho_d)[rows].numpy())
    # the JAX problem built on the same rows: float32 solves by two
    # LAPACKs
    want = JLinear(jnp.asarray(x[rows]), jnp.asarray(y[rows])).primal_solve(
        jnp.asarray(v[rows].numpy()), jnp.asarray(rho_d[rows].numpy()))
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-4, atol=1e-5)
    labels = np.where(y > 0, 1.0, -1.0).astype(np.float32)
    logit = solvers.LogisticRegressionProblem(torch.from_numpy(x),
                                              torch.from_numpy(labels))
    lpart = logit.take_workers(rows)
    assert lpart.n_workers == 4 and lpart.mu0 == logit.mu0
    np.testing.assert_array_equal(lpart.x.numpy(), x[rows])
    np.testing.assert_allclose(
        lpart.primal_solve(v[rows], rho_d[rows]).numpy(),
        logit.primal_solve(v, rho_d)[rows].numpy(), rtol=1e-6, atol=1e-7)


def test_engine_run_at_world_one_is_the_dense_run():
    """``EngineConfig(mix_backend="sharded")`` through ``engine.run``: with
    no process group a world of one, the dense run bit for bit (state and
    metrics)."""
    from repro_torch.core import admm_baselines as ab
    import dataclasses

    x, y = linear_problem()
    prob = solvers.LinearRegressionProblem(torch.from_numpy(x),
                                           torch.from_numpy(y))
    g = G.random_bipartite_graph(8, 0.4, seed=0)
    outs = {}
    for backend in ("dense", "sharded"):
        cfg = dataclasses.replace(ab.cq_ggadmm(rho=1.0), mix_backend=backend)
        state, out = E.run(g, cfg, E.ExactSolver(prob), torch.zeros((8, 12)),
                           12, seed=5,
                           extra_metrics=E.flat_metrics(g, backend,
                                                        device="cpu"))
        outs[backend] = (state, out)
    (s0, o0), (s1, o1) = outs["dense"], outs["sharded"]
    for k in o0:
        np.testing.assert_array_equal(o1[k].numpy(), o0[k].numpy(), err_msg=k)
    np.testing.assert_array_equal(s1.theta.numpy(), s0.theta.numpy())
    np.testing.assert_array_equal(s1.quant.q_hat.numpy(),
                                  s0.quant.q_hat.numpy())


def test_campaign_and_fleet_take_the_sharded_backend_at_world_one(tmp_path):
    """``campaign_lm_run(mix_backend="sharded")`` (no process group: a
    world of one) and the trainer's ``--fleet --mix-backend sharded`` (a
    gloo group of one) give the dense backend's losses and bits."""
    from repro_torch.campaign.runner import RunContext
    from repro_torch.launch import train

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        tiny = dict(workers=2, batch=2, seq=8, steps=2, local_steps=1)
        runs = {}
        for backend in ("dense", "sharded"):
            ctx = RunContext(None, tmp_path / backend, None, device="cpu")
            runs[backend] = train.campaign_lm_run(
                ["lm", backend], mix_backend=backend, ctx=ctx, **tiny).data
        for k in ("loss_history", "total_bits"):
            assert runs["sharded"][k] == runs["dense"][k], k
        flags = ["--smoke", "--workers", "4", "--batch", "4", "--seq", "8",
                 "--steps", "2", "--local-steps", "1", "--device", "cpu",
                 "--fleet", "--fleet-participation", "0.75"]
        dense = train.main(flags + ["--mix-backend", "dense"])
        sharded = train.main(flags + ["--mix-backend", "sharded"])
        assert not dist.is_initialized()
        assert sharded["history"] == dense["history"]
        assert sharded["total_bits"] == dense["total_bits"]
        assert sharded["sim"].topo.backend == "sharded"
    finally:
        torch.set_num_threads(n)
