"""The fleet simulator on the sharded topology over 2 and 4 ranks: spawned
processes, one torch thread each, in a gloo process group over a file
store. Each rank holds N/w workers' rows; every churn event gathers the
whole fleet state, remaps it and cuts the new rows. The runs are held to
the JAX package's *dense* ``FleetSim`` and ``run_fleet`` (its sharded
engine raises under jax 0.9.0: ROADMAP.md C22) and to the port's own
world-1 runs.

* The convex case: ``tests/test_torch_fleet.py``'s linreg fixture widened
  to 8 workers (so 2 and 4 ranks divide it), participation 0.8, staleness
  1, churn (4, 1, 1) and (8, 0, 4) (8 -> 8 -> 12 workers), 12 rounds, the
  JAX draws injected. Against the JAX dense ``FleetSim``: ``tx_mask``,
  ``fleet_timer`` and ``payload_bits`` equal round for round, theta within
  1e-4 max|theta*|, as in ``test_torch_fleet.py``. Against the port's
  world-1 run: state, timers, ``tx_mask`` and bits bit for bit (the
  all-gathers move rows unchanged; each rank's solve and quantize see the
  same rows and draws).
* The refusal case: at 4 ranks a churn (3, 2, 0) (8 -> 6 workers) raises
  the topology's divisibility ``ValueError`` on every rank at round 3,
  inside the spawn's time limit (no rank is left in a collective); at 2
  ranks the same schedule runs.
* The trainer: ``--fleet --mix-backend sharded`` at 2 ranks on
  ``test_torch_fleet.py``'s xlstm-smoke flags plus ``--fleet-churn 1:1:1``,
  against the JAX dense ``run_fleet`` at that file's tolerances
  (unquantized: loss rel 1e-4, total bits equal; cq-ggadmm with the JAX
  draws: loss within 1e-3), and against the port's world-1 run: bits, tx
  and churn log equal, the loss within rel 1e-5. Not 1e-6, and not bit
  for bit: a rank that holds one worker of a phase solves it alone, and
  on the CPU ``torch.einsum``'s backward (the mLSTM's chunkwise sums)
  rounds differently at a batch of one than at two (ROADMAP.md C26), so
  the world-1 and 2-rank trajectories part by float32 rounding from round
  0 (loss rel 1.3e-6 unquantized and 6.5e-6 quantized by round 2). The
  engine's state moves bit for bit otherwise: the convex case above, and
  tinyllama-smoke's fleet in ``test_torch_sharded_ranks.py``.
"""
import pickle
from concurrent.futures import ProcessPoolExecutor
import threading
import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro.configs import base as jbase
from repro.core import engine as JE
from repro.core.censoring import CensorConfig as JCensor
from repro.core.quantization import QuantConfig as JQuant
from repro.core.solvers import LinearRegressionProblem as JaxLinear
from repro.data import lm as jlm
from repro.fleet import faults as jfaults
from repro.fleet import sim as jsim
from repro.launch import train as jtrain
from repro.models import registry as jregistry
from repro.runtime import steps as JST
from repro_torch import interop
from repro_torch.configs import base
from repro_torch.core import engine as E
from repro_torch.core import tree as T
from repro_torch.core.censoring import CensorConfig
from repro_torch.core.graph import random_bipartite_graph
from repro_torch.core.quantization import QuantConfig
from repro_torch.data import regression as R
from repro_torch.fleet import faults
from repro_torch.fleet import sim
from repro_torch.launch import train

N, DIM, ROUNDS, SEED = 8, 12, 12, 2
CHURN = ((4, 1, 1), (8, 0, 4))           # 8 -> 8 -> 12 workers
REFUSED = ((3, 2, 0),)                   # 8 -> 6: 4 ranks do not divide 6
LM_N, LM_BATCH, LM_SEQ, LM_ROUNDS = 4, 4, 16, 3
SPAWN_TIMEOUT = 240.0


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------ the convex case --
def linreg_data():
    return R.partition_uniform(R.synth_linear(n=N * 30, d=DIM, seed=0), N)


def graph0():
    return random_bipartite_graph(N, 0.4, seed=0)


def fault_config(churn, mod=faults):
    return mod.FaultConfig(participation=0.8, staleness=1, seed=1, churn=tuple(
        mod.ChurnEvent(round=r, leave=lv, join=j) for r, lv, j in churn))


def engine_cfg(mix_backend):
    return E.EngineConfig(
        rho=1.0, censor=CensorConfig(tau0=0.5, xi=0.97),
        quantize=QuantConfig(b0=2, omega=0.99), groups="leaf",
        mix_backend=mix_backend)


def theta0():
    return {"w": torch.zeros((N, DIM - 4)), "b": torch.zeros((N, 4))}


def members_at(r, churn=CHURN):
    """The worker count at round ``r`` of a churn schedule."""
    n = N
    for at, leave, join in churn:
        if r >= at:
            n += join - leave
    return n


def jax_draws(seed):
    """The JAX FleetSim's draws: round r's key ``fold_in(PRNGKey(seed),
    r)``, split into one key per engine phase (``test_torch_fleet.py``)."""
    base_key = jax.random.PRNGKey(seed)

    def uniforms(r, phase, n, dim):
        k = jax.random.split(jax.random.fold_in(base_key, r))[phase]
        return torch.from_numpy(np.array(
            jax.random.uniform(k, (n, dim), jnp.float32)))
    return uniforms


def convex_run(churn=CHURN, inject=True, mix_backend="sharded"):
    """FleetSim on the linreg fixture, the solver rebuilt for the members
    at each churn event; the state gathered from every rank and the
    rounds the run reached."""
    x, y = linreg_data()
    reached = []

    def solver_factory(members, graph):
        rows = np.asarray([int(g) % N for g in members])
        return E.ExactSolver(interop.problem_from_numpy(
            x[rows], y[rows], "linear", device="cpu"))

    def batch_fn(r, members):
        reached.append(r)
        return None

    draws = jax_draws(SEED)
    fsim = sim.FleetSim(
        N, engine_cfg(mix_backend),
        sim.FleetConfig(rounds=ROUNDS, seed=SEED,
                        faults=fault_config(churn)),
        theta0(), solver_factory=solver_factory, batch_fn=batch_fn,
        graph0=graph0(),
        uniforms=(lambda r, ph: draws(r, ph, members_at(r, churn), DIM))
        if inject else None)
    try:
        fs, m = fsim.run()
    except ValueError as e:
        return {"error": str(e), "reached": reached,
                "n_members": len(fsim.members)}
    topo = fsim.topo

    def whole(tree):
        return [x.numpy() for x in T.leaves(E.gather_workers(tree, topo))]

    st, q = fs.engine, fs.engine.quant
    state = {"theta": whole(st.theta), "theta_hat": whole(st.theta_hat),
             "alpha": whole(st.alpha), "q_hat": whole(q.q_hat),
             "held_hat": whole(fs.held_hat)}
    for name in ("range_prev", "bits_prev", "delta_prev", "initialized"):
        state[name] = whole(getattr(q, name))
    state["held_payload"] = whole(fs.held_payload)
    state["timer"] = whole(fs.timer)
    keys = ("tx_mask", "fleet_timer", "payload_bits", "payload_bits_total",
            "tx_count", "n_members", "fleet_participation", "fleet_deliver",
            "censor_mask")
    return {"state": state, "metrics": {k: m[k] for k in keys},
            "churn_log": m["churn_log"], "reached": reached,
            "world": topo.world, "rows": topo.worker_rows(topo.n)}


def jax_convex():
    x, y = linreg_data()

    def solver_factory(members, graph):
        rows = np.asarray([int(g) % N for g in members])
        return JE.ExactSolver(JaxLinear(jnp.asarray(x[rows]),
                                        jnp.asarray(y[rows])))

    jcfg = JE.EngineConfig(
        rho=1.0, censor=JCensor(tau0=0.5, xi=0.97),
        quantize=JQuant(b0=2, omega=0.99), groups="leaf",
        mix_backend="dense")
    theta = {"w": jnp.zeros((N, DIM - 4), jnp.float32),
             "b": jnp.zeros((N, 4), jnp.float32)}
    fs, m = jsim.FleetSim(
        N, jcfg, jsim.FleetConfig(rounds=ROUNDS, seed=SEED,
                                  faults=fault_config(CHURN, jfaults)),
        theta, solver_factory=solver_factory, graph0=graph0()).run()
    star = float(np.abs(np.asarray(JaxLinear(
        jnp.asarray(x), jnp.asarray(y)).optimum())).max())
    return {"theta": [np.asarray(fs.engine.theta[k]) for k in ("b", "w")],
            "metrics": m, "star": star}


# ------------------------------------------------------ the LM trainer --
def lm_flags(quantize, backend="sharded"):
    return ["--arch", "xlstm-125m", "--smoke", "--workers", str(LM_N),
            "--batch", str(LM_BATCH), "--seq", str(LM_SEQ), "--steps",
            str(LM_ROUNDS), "--local-steps", "2", "--lr", "2e-3", "--xi",
            "0.999", "--bits", "6", "--omega", "0.9995", "--groups", "leaf",
            "--device", "cpu", "--log-every", "1", "--mix-backend", backend,
            "--fleet", "--fleet-participation", "0.75",
            "--fleet-staleness", "2", "--fleet-churn", "1:1:1"] + (
        ["--tau0", "5.0"] if quantize else ["--no-quantize", "--tau0", "0"])


def lm_config():
    return base.get_smoke_config("xlstm-125m").with_overrides(dtype="float32")


def lm_run(work, quantize):
    """``train.run_admm`` with ``--fleet --mix-backend sharded`` from the JAX
    init (cq: the JAX draws injected), float32 activations."""
    params = interop.tree_from_numpy(dict(np.load(work / "lm_params.npz")),
                                     device="cpu")
    args = train.build_parser().parse_args(lm_flags(quantize))
    uniforms = None
    if quantize:
        dim = sum(x.numel() for x in T.leaves(params))
        draws = jax_draws(0)
        uniforms = lambda r, ph: draws(r, ph, LM_N, dim)  # noqa: E731
    out = train.run_admm(lm_config(), args, params=params, uniforms=uniforms)
    m = out["metrics"]
    return {"history": out["history"], "total_bits": out["total_bits"],
            "tx_count": m["tx_count"].tolist(),
            "payload_bits_total": m["payload_bits_total"].tolist(),
            "churn_log": out["churn_log"], "n_groups": out["n_groups"]}


def jax_run_fleet(quantize):
    """The JAX package's ``run_fleet`` on the dense backend at the same
    settings, float32 (``test_torch_fleet.py``'s, with the churn)."""
    jcfg = jbase.get_smoke_config("xlstm-125m").with_overrides(
        dtype="float32")
    ecfg = JE.EngineConfig(
        rho=0.01, censor=JCensor(tau0=5.0, xi=0.999) if quantize
        else JCensor(), quantize=JQuant(b0=6, omega=0.9995)
        if quantize else None, groups="leaf", mix_backend="dense")

    def grad_fn(theta, batch):
        return jax.vmap(lambda p, b: jax.grad(
            lambda pp: jregistry.lm_loss(pp, jcfg, b)[0])(p))(theta, batch)

    def loss_fn(theta, batch):
        return jnp.mean(jax.vmap(
            lambda p, b: jregistry.lm_loss(p, jcfg, b)[0])(theta, batch))

    solver = JE.InexactSolver(grad_fn=grad_fn, local_steps=2, local_lr=2e-3)
    one = jregistry.init_params(jcfg, jax.random.PRNGKey(0))
    params = jax.tree_util.tree_map(
        lambda x: jnp.broadcast_to(x[None], (LM_N,) + x.shape), one)
    args = types.SimpleNamespace(
        steps=LM_ROUNDS, batch=LM_BATCH, workers=LM_N, seed=0, log_every=1,
        fleet_participation=0.75, fleet_staleness=2, fleet_stale_frac=1.0,
        fleet_churn="1:1:1", fleet_seed=0, ckpt_dir=None)
    data = jlm.SyntheticLM(jlm.SyntheticLMConfig(jcfg.vocab_size, LM_SEQ))
    return jtrain.run_fleet(jcfg, args, JST.worker_graph(LM_N, "random"),
                            ecfg, solver, loss_fn, params, data)


# ------------------------------------------------------- the spawns --
JOBS = {
    "convex": lambda work: convex_run(),
    "refused": lambda work: convex_run(REFUSED, inject=False),
    "lm": lambda work: {q: lm_run(work, q) for q in (False, True)},
}


def rank_main(rank, world, work, jobs):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method="file://" + str(
        work / f"store{world}"), rank=rank, world_size=world)
    try:
        res = {name: JOBS[name](work) for name in jobs}
    finally:
        dist.destroy_process_group()
    with open(work / f"world{world}_rank{rank}.pkl", "wb") as f:
        pickle.dump(res, f)


def run_ranks(work, world, jobs):
    """Spawn ``world`` ranks running ``jobs``; kill them and raise if they
    have not all ended within SPAWN_TIMEOUT seconds (a rank left in a
    collective)."""
    ctx = mp.spawn(rank_main, args=(world, work, jobs), nprocs=world,
                   join=False)
    deadline = time.monotonic() + SPAWN_TIMEOUT
    while not ctx.join(timeout=max(deadline - time.monotonic(), 0.1)):
        if time.monotonic() >= deadline:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError(f"{world} ranks still running after "
                               f"{SPAWN_TIMEOUT:.0f} s")
    out = []
    for r in range(world):
        with open(work / f"world{world}_rank{r}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return out


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    """The 2- and 4-rank runs (in a thread, one world after the other)
    beside the JAX references (the trainer's in two processes) and the
    port's world-1 runs (no process group: a world of one)."""
    d = tmp_path_factory.mktemp("sharded_fleet")
    one = jregistry.init_params(jbase.get_smoke_config(
        "xlstm-125m").with_overrides(dtype="float32"), jax.random.PRNGKey(0))
    np.savez(d / "lm_params.npz", **{
        jax.tree_util.keystr(p): np.asarray(v)
        for p, v in jax.tree_util.tree_flatten_with_path(one)[0]})
    spawned = {}

    def spawn():
        try:
            spawned[2] = run_ranks(d, 2, list(JOBS))
            spawned[4] = run_ranks(d, 4, ["convex", "refused"])
        except BaseException as e:          # re-raised in the test process
            spawned["error"] = e

    # the JAX trainer references (the slowest part: jit compiles) run in
    # processes of their own, beside the ranks and the work below
    pool = ProcessPoolExecutor(max_workers=2,
                               mp_context=mp.get_context("spawn"))
    thread = threading.Thread(target=spawn)
    thread.start()
    try:
        jax_lm = {q: pool.submit(jax_run_fleet, q) for q in (False, True)}
        refs = {"convex": jax_convex()}
        world1 = {"convex": convex_run(),
                  "refused": convex_run(REFUSED, inject=False),
                  "lm": {q: lm_run(d, q) for q in (False, True)}}
        refs["lm"] = {q: f.result() for q, f in jax_lm.items()}
    finally:
        pool.shutdown(cancel_futures=True)
        thread.join()
    if "error" in spawned:
        raise spawned["error"]
    return refs, world1, spawned


# ---------------------------------------------------------- the tests --
@pytest.mark.parametrize("world", [2, 4])
def test_convex_fleet_matches_the_jax_dense_fleetsim(work, world):
    refs = work[0]["convex"]
    jm = refs["metrics"]
    got = work[2][world][0]["convex"]
    m = got["metrics"]
    assert got["world"] == world
    assert m["n_members"].tolist() == [8] * 8 + [12] * 4
    assert [(e["round"], e["n_members"]) for e in got["churn_log"]] == [
        (4, 8), (8, 12)]
    assert any((p == 0).any() for p in m["fleet_participation"])
    for k in ("tx_mask", "fleet_timer", "payload_bits"):
        assert len(m[k]) == len(jm[k]) == ROUNDS, k
        for r, (a, b) in enumerate(zip(m[k], jm[k])):
            np.testing.assert_array_equal(a, np.asarray(b),
                                          err_msg=f"{k} round {r}")
    np.testing.assert_array_equal(m["payload_bits_total"],
                                  np.asarray(jm["payload_bits_total"]))
    for a, b in zip(got["state"]["theta"], refs["theta"]):
        assert a.shape == b.shape == (12,) + b.shape[1:]
        assert np.abs(a - b).max() <= 1e-4 * refs["star"]


@pytest.mark.parametrize("world", [2, 4])
def test_convex_fleet_equals_the_world_one_run(work, world):
    want = work[1]["convex"]
    per_rank = work[2][world]
    assert [r["convex"]["rows"] for r in per_rank] == [
        slice(i * 12 // world, (i + 1) * 12 // world) for i in range(world)]
    for got in (r["convex"] for r in per_rank):
        for name, arrays in want["state"].items():
            for a, b in zip(got["state"][name], arrays):
                np.testing.assert_array_equal(a, b, err_msg=name)
        for k, v in want["metrics"].items():
            for a, b in zip(got["metrics"][k], v):
                np.testing.assert_array_equal(a, b, err_msg=k)
        assert got["churn_log"] == want["churn_log"]


def test_churn_to_an_indivisible_worker_count_raises_on_every_rank(work):
    # 4 ranks: every rank raises at round 3, after rounds 0-2 ran
    for res in (r["refused"] for r in work[2][4]):
        assert "sharded mix needs workers (6) divisible by the process " \
               "group's world size (4)" in res["error"]
        assert res["reached"] == [0, 1, 2] and res["n_members"] == 8
    # 2 ranks divide 6: the schedule runs, as at one rank
    want = work[1]["refused"]
    assert "error" not in want
    for res in (r["refused"] for r in work[2][2]):
        assert "error" not in res and res["reached"] == list(range(ROUNDS))
        assert res["metrics"]["n_members"].tolist() == [8] * 3 + [6] * 9
        for name, arrays in want["state"].items():
            for a, b in zip(res["state"][name], arrays):
                np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.mark.parametrize("quantize", [False, True], ids=["ggadmm",
                                                         "cq-ggadmm"])
def test_sharded_fleet_trainer_matches_the_jax_dense_run_fleet(work,
                                                               quantize):
    jout = work[0]["lm"][quantize]
    a, b = (r["lm"][quantize] for r in work[2][2])
    # every rank returns the same result
    assert a == b
    assert [e["round"] for e in a["churn_log"]] == [1]
    assert a["churn_log"] == [
        {k: e[k] for k in ("round", "left", "joined", "n_members")}
        for e in jout["churn_log"]]
    if quantize:
        assert a["n_groups"] == 19 == jout["n_groups"]
        np.testing.assert_allclose(a["history"], jout["history"], atol=1e-3)
    else:
        np.testing.assert_allclose(a["history"], jout["history"], rtol=1e-4)
        assert a["total_bits"] == jout["total_bits"]
    assert np.isfinite(a["history"]).all()
    world1 = work[1]["lm"][quantize]
    assert a["total_bits"] == world1["total_bits"]
    assert a["tx_count"] == world1["tx_count"]
    assert a["payload_bits_total"] == world1["payload_bits_total"]
    assert a["churn_log"] == world1["churn_log"]
    np.testing.assert_allclose(a["history"], world1["history"], rtol=1e-5)
