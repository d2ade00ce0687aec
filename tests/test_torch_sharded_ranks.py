"""The sharded topology over 2 and 4 ranks: spawned processes, one torch
thread each, in a gloo process group over a file store. Each rank holds
N/w workers' rows; the runs are held to the JAX package's *dense* engine
(its sharded engine raises under jax 0.9.0: ROADMAP.md C22) and to the
port's own world-1 run.

Tolerances and their reasons:

* ggadmm, c-ggadmm and cq-ggadmm on ``tests/test_topology.py``'s linreg
  fixture (8 workers, d 12, 40 iterations, seed 3), cq with the JAX draws
  injected, against the JAX dense ``E.run``: that test's tolerances,
  ``tx_mask`` equal, primal residual rtol 1e-3 and atol 1e-5, theta rtol
  1e-4 and atol 1e-5, payload bits rtol 1e-6. cq-ggadmm is held so over
  the iterations before its first stochastic-rounding flip (iteration 14:
  the port's dense run parts from the JAX one there too, the two
  packages' float32 solves sitting on either side of one rounding
  decision; ROADMAP.md C2), except theta, and its cumulative bits within
  C2's 3%. Its theta trajectory before the flip is held to
  ``test_torch_engine.py``'s 1e-4 max|theta|: the two packages' float32
  solves differ (~1e-7 relative) and the quantizer's steps carry that on,
  so by iteration 13 five of 1,344 trajectory entries sit beyond rtol 1e-4
  and atol 1e-5 (at most 3.3e-5 apart; the port's dense run alike).
* against the port's world-1 run: state, ``tx_mask`` and bits bit for bit
  (the all-gather moves rows unchanged, each rank's solve and quantize
  see the same rows and draws). Not bit for bit: the primal residual, an
  all-reduce of per-rank partial sums (relative 1e-6), and on the pytree
  and trainer runs the worker means (consensus error, loss), the mean of
  the ranks' means (relative 1e-6).
* the pytree InexactSolver case (``test_engine_backend_pytree_training_
  agrees``' problem with numpy-seeded targets) at 2 ranks against the JAX
  dense run: theta rtol 1e-4 atol 1e-5, consensus error rtol 1e-3.
* the trainer (tinyllama-smoke, float32, 4 workers, 2 steps, from the JAX
  init) at 2 ranks against the JAX dense ``run_admm`` loop:
  ``test_torch_consensus.py``'s tolerances (ggadmm: loss rel 1e-4, theta
  within 1e-4 max|theta| on all but 1e-4 of the elements and within 1e-3
  on all; cq-ggadmm with the JAX draws: bit widths per (worker, group)
  equal at both steps, loss within 1e-3).
"""
import dataclasses
import os
import pickle
import subprocess
import sys
import threading
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro.configs import base as jbase
from repro.core import admm_baselines as jab
from repro.core import engine as JE
from repro.core.censoring import CensorConfig as JCensor
from repro.core.graph import random_bipartite_graph as jax_graph
from repro.core.quantization import QuantConfig as JQuant
from repro.core.solvers import LinearRegressionProblem as JLinear
from repro.data import lm as jlm
from repro.data import regression as JR
from repro.models import registry as jregistry
from repro.runtime import steps as JST
from repro_torch import interop
from repro_torch.configs import base
from repro_torch.core import admm_baselines as ab
from repro_torch.core import engine as E
from repro_torch.core import topology as TP
from repro_torch.core import tree as T
from repro_torch.core.graph import chain_graph, random_bipartite_graph
from repro_torch.core.solvers import LinearRegressionProblem
from repro_torch.launch import train
from repro_torch.runtime import steps as ST

ROOT = Path(__file__).resolve().parents[1]
N_LIN, DIM, ITERS, SEED = 8, 12, 40, 3
SCHEMES = ("ggadmm", "c-ggadmm", "cq-ggadmm")
FLIP = 14                    # cq-ggadmm's first rounding flip against JAX
N_TREE, TREE_ITERS = 6, 30
ARCH, N_LM, BATCH, SEQ, STEPS = "tinyllama-1.1b", 4, 4, 16, 2


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --------------------------------------------------- what a rank runs --
def lm_flags(quantize, extra=()):
    return ["--arch", ARCH, "--smoke", "--workers", str(N_LM),
            "--batch", str(BATCH), "--seq", str(SEQ), "--steps", str(STEPS),
            "--local-steps", "2", "--lr", "2e-3", "--xi", "0.999",
            "--bits", "6", "--omega", "0.9995", "--groups", "leaf",
            "--device", "cpu", "--log-every", "1",
            "--mix-backend", "sharded"] + list(extra) + (
        ["--tau0", "5.0"] if quantize else ["--no-quantize", "--tau0", "0"])


def linreg_run(work, scheme, mix_backend="sharded"):
    """One scheme on the linreg fixture through ``engine.run``; the metrics
    and final theta gathered over the ranks."""
    x, y = np.load(work / "x.npy"), np.load(work / "y.npy")
    g = random_bipartite_graph(N_LIN, 0.4, seed=0)
    prob = LinearRegressionProblem(torch.from_numpy(x), torch.from_numpy(y))
    cfg = dataclasses.replace(ab.ALL_SCHEMES[scheme](rho=1.0),
                              mix_backend=mix_backend)
    topo = TP.build(g, mix_backend, device="cpu")
    uniforms = None
    if cfg.quantize is not None:
        draws = np.load(work / "linreg_draws.npy", mmap_mode="r")
        uniforms = lambda it, ph: torch.from_numpy(np.array(draws[it, ph]))
    state, out = E.run(g, cfg, E.ExactSolver(prob), torch.zeros((N_LIN, DIM)),
                       ITERS, seed=SEED, extra_metrics=E.flat_metrics(g, topo),
                       topology=topo, uniforms=uniforms)
    out = E.gather_workers(out, topo, dim=1)
    res = {k: out[k].numpy() for k in ("tx_mask", "primal_residual",
                                       "payload_bits", "dual_residual")}
    res["theta"] = E.gather_workers(state.theta, topo).numpy()
    res["trajectory"] = out["theta"].numpy()
    res["q_hat"] = E.gather_workers(state.quant.q_hat, topo).numpy()
    res["rows"] = (topo.row0, topo.worker_rows(N_LIN).stop)
    return res


def quadratic_targets():
    rng = np.random.default_rng(0)
    return {"w": (2.0 * rng.standard_normal((N_TREE, 8, 4))).astype(
        np.float32), "b": rng.standard_normal((N_TREE, 16)).astype(np.float32)}


def pytree_run(mix_backend="sharded"):
    """The JAX pytree test's problem: per-worker targets (riding in the
    batch, so the inexact solver sees the acting rows'), Adam, 30
    iterations, unquantized."""
    g = random_bipartite_graph(N_TREE, 0.5, seed=0)
    cfg = E.EngineConfig(rho=0.5, mix_backend=mix_backend)
    topo = TP.build(g, mix_backend, device="cpu")
    targets = E.cut_workers(T.tree_map(torch.from_numpy, quadratic_targets()),
                            topo)
    solver = E.InexactSolver(grad_fn=lambda th, b: T.tree_map(
        lambda t, c: t - c, th, b), local_steps=5, local_lr=0.2)
    state = E.init_state(T.tree_map(torch.zeros_like, targets), cfg, solver)
    step = E.make_step(g, cfg, solver, topology=topo,
                       extra_metrics=E.consensus_metrics(topology=topo))
    for _ in range(TREE_ITERS):
        state, m = step(state, None, targets)
    return {"w": E.gather_workers(state.theta["w"], topo).numpy(),
            "b": E.gather_workers(state.theta["b"], topo).numpy(),
            "consensus_err": float(m["consensus_err"]),
            "dual_residual": float(m["dual_residual"])}


def regroup_trees():
    """Two rounds of (theta, q_hat) over a 4-leaf tree, 4 workers, each
    leaf's largest move on another worker: a rank alone sees other ranges
    than the whole."""
    rng = np.random.default_rng(9)
    shapes = {"a": (8,), "b": (3, 5), "c": (6,), "d": (10,)}
    rounds = []
    for r in range(2):
        theta, q = {}, {}
        for i, (k, s) in enumerate(sorted(shapes.items())):
            scale = np.full((4,) + (1,) * len(s), 1e-3, np.float32)
            scale[(i + r) % 4] = 10.0 ** (i - 1)
            theta[k] = (scale * rng.standard_normal((4,) + s)).astype(
                np.float32)
            q[k] = np.zeros((4,) + s, np.float32)
        rounds.append((theta, q))
    return rounds


def regroup_run():
    """AutoGrouper.regroup on the rank's rows, with and without the
    topology (the cross-rank max)."""
    topo = TP.build(chain_graph(4), "sharded", device="cpu")
    shared = E.AutoGrouper(k=2, regroup_every=1)
    alone = E.AutoGrouper(k=2, regroup_every=1)
    ids, local = [], []
    for theta, q in regroup_trees():
        th = E.cut_workers(T.tree_map(torch.from_numpy, theta), topo)
        qq = E.cut_workers(T.tree_map(torch.from_numpy, q), topo)
        ids.append(shared.regroup(th, qq, topo))
        local.append(alone.regroup(th, qq))
    return {"ids": ids, "local": local}


def jax_init_params(work):
    flat = np.load(work / "lm_params.npz")
    return interop.tree_from_numpy(dict(flat), device="cpu")


def lm_run(work, quantize):
    """``train.run_admm`` on the sharded backend from the JAX init (cq: the
    JAX draws injected), float32 activations."""
    cfg = base.get_smoke_config(ARCH).with_overrides(dtype="float32")
    args = train.build_parser().parse_args(lm_flags(quantize))
    uniforms = None
    if quantize:
        draws = np.load(work / "lm_draws.npy", mmap_mode="r")
        uniforms = lambda i, ph: torch.from_numpy(np.array(draws[i, ph]))
    out = train.run_admm(cfg, args, params=jax_init_params(work),
                         uniforms=uniforms)
    topo = TP.build(lm_graph(), "sharded", device="cpu")
    theta = E.gather_workers(out["state"].theta, topo)
    return {"history": out["history"], "total_bits": out["total_bits"],
            "n_groups": out["n_groups"],
            "bits_per_group": [np.asarray(b) for b in out["bits_per_group"]],
            "theta": [x.numpy() for x in T.leaves(theta)]}


def lm_graph():
    return ST.worker_graph(N_LM, "random")


def lm_regroup_run():
    """The trainer with ``--groups auto:2 --regroup-every 1`` (seeded init
    and draws, 3 steps): the regrouped widths each step."""
    flags = lm_flags(True, ["--regroup-every", "1"]) + ["--steps", "3"]
    flags[flags.index("leaf")] = "auto:2"
    out = train.main(flags)
    return {"history": out["history"], "n_groups": out["n_groups"],
            "bits_per_group": [np.asarray(b) for b in out["bits_per_group"]]}


POD_PAIR = ["--smoke", "--workers", "2", "--batch", "2", "--seq", "8",
            "--steps", "2", "--local-steps", "1", "--device", "cpu",
            "--mix-backend", "sharded"]


def pod_pair_run():
    """The trainer on the pod-pair graph: at two ranks each holds one
    worker, so each rank sits out one phase's local solve."""
    out = train.main(POD_PAIR)
    return {"history": out["history"], "total_bits": out["total_bits"],
            "tx_counts": out["tx_counts"]}


def refusals():
    """What the sharded path refuses at more than one rank."""
    msgs = {}
    try:
        train.main(lm_flags(False, ["--fleet"]))
    except SystemExit as e:
        msgs["fleet"] = str(e)
    try:
        TP.build(chain_graph(9), "sharded", device="cpu")
    except ValueError as e:
        msgs["divisible"] = str(e)
    return msgs


JOBS = {
    "linreg": lambda work: {s: linreg_run(work, s) for s in SCHEMES},
    "pytree": lambda work: pytree_run(),
    "regroup": lambda work: regroup_run(),
    "lm": lambda work: {q: lm_run(work, q) for q in (False, True)},
    "lm_regroup": lambda work: lm_regroup_run(),
    "pod_pair": lambda work: pod_pair_run(),
    "refusals": lambda work: refusals(),
}


def rank_main(rank, world, work, jobs):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method="file://" + str(
        work / "store"), rank=rank, world_size=world)
    try:
        res = {name: JOBS[name](work) for name in jobs}
    finally:
        dist.destroy_process_group()
    with open(work / f"rank{rank}.pkl", "wb") as f:
        pickle.dump(res, f)


def run_ranks(work, world, jobs):
    mp.spawn(rank_main, args=(world, work, jobs), nprocs=world, join=True)
    out = []
    for r in range(world):
        with open(work / f"rank{r}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return out


# --------------------------------------------------- the references --
def jax_uniforms(n, d):
    """The JAX engine's one-leaf draws for ``E.run(seed=SEED)``."""
    def one(key):
        k1, k2 = jax.random.split(key)
        return jnp.stack([jax.random.uniform(k1, (n, d), jnp.float32),
                          jax.random.uniform(k2, (n, d), jnp.float32)])
    keys = jax.random.split(jax.random.PRNGKey(SEED), ITERS)
    return np.asarray(jax.jit(jax.vmap(one))(keys))


def jax_linreg(x, y):
    g = jax_graph(N_LIN, 0.4, seed=0)
    prob = JLinear(jnp.asarray(x), jnp.asarray(y))
    out = {}
    for scheme in SCHEMES:
        state, m = JE.run(g, jab.ALL_SCHEMES[scheme](rho=1.0),
                          JE.ExactSolver(prob),
                          jnp.zeros((N_LIN, DIM), jnp.float32), ITERS,
                          seed=SEED, extra_metrics=JE.flat_metrics(g))
        out[scheme] = {k: np.asarray(m[k]) for k in (
            "tx_mask", "primal_residual", "payload_bits")}
        out[scheme]["theta"] = np.asarray(m["theta"])
    return out


def jax_pytree():
    targets = {k: jnp.asarray(v) for k, v in quadratic_targets().items()}
    g = jax_graph(N_TREE, 0.5, seed=0)
    solver = JE.InexactSolver(grad_fn=lambda th, b: jax.tree_util.tree_map(
        lambda t, c: t - c, th, b), local_steps=5, local_lr=0.2)
    cfg = JE.EngineConfig(rho=0.5)
    state = JE.init_state(jax.tree_util.tree_map(jnp.zeros_like, targets),
                          cfg, solver)
    step = jax.jit(JE.make_step(g, cfg, solver,
                                extra_metrics=JE.consensus_metrics()))
    for i in range(TREE_ITERS):
        state, m = step(state, targets, jax.random.PRNGKey(i))
    return {"w": np.asarray(state.theta["w"]),
            "b": np.asarray(state.theta["b"]),
            "consensus_err": float(m["consensus_err"])}


def jax_lm_config():
    return jbase.get_smoke_config(ARCH).with_overrides(dtype="float32")


def jax_run_admm(quantize):
    """The JAX package's run_admm loop on the dense backend, float32: the
    final state and every step's metrics (``test_torch_attn_consensus.py``'s
    loop at STEPS steps)."""
    jcfg = jax_lm_config()

    def grad_fn(theta, batch):
        return jax.vmap(lambda p, b: jax.grad(
            lambda pp: jregistry.lm_loss(pp, jcfg, b)[0])(p))(theta, batch)

    def loss_fn(theta, batch):
        return jnp.mean(jax.vmap(
            lambda p, b: jregistry.lm_loss(p, jcfg, b)[0])(theta, batch))

    ecfg = JE.EngineConfig(
        rho=0.01, censor=JCensor(tau0=5.0, xi=0.999) if quantize
        else JCensor(), quantize=JQuant(b0=6, omega=0.9995)
        if quantize else None, groups="leaf")
    solver = JE.InexactSolver(grad_fn=grad_fn, local_steps=2, local_lr=2e-3)
    one = jregistry.init_params(jcfg, jax.random.PRNGKey(0))
    state = JE.init_state(jax.tree_util.tree_map(
        lambda x: jnp.broadcast_to(x[None], (N_LM,) + x.shape), one),
        ecfg, solver)
    step = jax.jit(JE.make_step(JST.worker_graph(N_LM, "random"), ecfg,
                                solver,
                                extra_metrics=JE.consensus_metrics(loss_fn)))
    data = jlm.SyntheticLM(jlm.SyntheticLMConfig(jcfg.vocab_size, SEQ))
    metrics = []
    for i in range(STEPS):
        batch = jlm.model_batch(jcfg, data.worker_batch(i, N_LM,
                                                        BATCH // N_LM),
                                key=jax.random.PRNGKey(i))
        state, m = step(state, batch, jax.random.PRNGKey(1000 + i))
        metrics.append(jax.tree_util.tree_map(np.asarray, m))
    return state, metrics


def jax_lm_draws(dim):
    out = np.empty((STEPS, 2, N_LM, dim), np.float32)
    for i in range(STEPS):
        for ph, k in enumerate(jax.random.split(
                jax.random.PRNGKey(1000 + i))):
            out[i, ph] = np.asarray(jax.random.uniform(k, (N_LM, dim),
                                                       jnp.float32))
    return out


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    """The inputs every rank reads; the 2- and 4-rank runs (in a thread,
    one world after the other) beside the JAX references and the port's
    world-1 runs (no process group: a world of one)."""
    d = tmp_path_factory.mktemp("sharded_ranks")
    x, y = JR.partition_uniform(JR.synth_linear(n=240, d=DIM, seed=0), N_LIN)
    np.save(d / "x.npy", np.asarray(x, np.float32))
    np.save(d / "y.npy", np.asarray(y, np.float32))
    np.save(d / "linreg_draws.npy", jax_uniforms(N_LIN, DIM))
    one = jregistry.init_params(jax_lm_config(), jax.random.PRNGKey(0))
    flat = {jax.tree_util.keystr(p): np.asarray(v) for p, v in
            jax.tree_util.tree_flatten_with_path(one)[0]}
    np.savez(d / "lm_params.npz", **flat)
    np.save(d / "lm_draws.npy", jax_lm_draws(
        sum(v.size for v in flat.values())))
    spawned = {}

    def spawn():
        try:
            spawned[2] = run_ranks(rank_dir(d, 2), 2, list(JOBS))
            spawned[4] = run_ranks(rank_dir(d, 4), 4, ["linreg", "refusals"])
        except BaseException as e:          # re-raised in the test process
            spawned["error"] = e

    thread = threading.Thread(target=spawn)
    thread.start()
    try:
        refs = {"linreg": jax_linreg(x, y), "pytree": jax_pytree(),
                "lm": {q: jax_run_admm(q) for q in (False, True)}}
        world1 = {"linreg": {s: linreg_run(d, s) for s in SCHEMES},
                  "pytree": pytree_run(),
                  "lm": {q: lm_run(d, q) for q in (False, True)},
                  "pod_pair": pod_pair_run()}
    finally:
        thread.join()
    if "error" in spawned:
        raise spawned["error"]
    return d, refs, world1, spawned


def rank_dir(root, world):
    d = root / f"world{world}"
    d.mkdir(exist_ok=True)
    for name in ("x.npy", "y.npy", "linreg_draws.npy", "lm_params.npz",
                 "lm_draws.npy"):
        os.symlink(root / name, d / name)
    return d


@pytest.fixture(scope="module")
def ranks2(work):
    return work[3][2]


def ranks(work, world):
    return work[3][world]


# ---------------------------------------------------------- the tests --
@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("scheme", SCHEMES)
def test_linreg_matches_the_jax_dense_engine(work, world, scheme):
    got = ranks(work, world)[0]["linreg"][scheme]
    want = work[1]["linreg"][scheme]
    upto = FLIP if scheme == "cq-ggadmm" else ITERS
    np.testing.assert_array_equal(got["tx_mask"][:upto],
                                  want["tx_mask"][:upto])
    np.testing.assert_allclose(got["primal_residual"][:upto],
                               want["primal_residual"][:upto],
                               rtol=1e-3, atol=1e-5)
    np.testing.assert_allclose(got["payload_bits"][:upto],
                               want["payload_bits"][:upto], rtol=1e-6)
    if scheme == "cq-ggadmm":
        err = np.abs(got["trajectory"][:upto] - want["theta"][:upto]).max()
        assert err <= 1e-4 * np.abs(want["theta"]).max(), err
    else:
        np.testing.assert_allclose(got["trajectory"], want["theta"],
                                   rtol=1e-4, atol=1e-5)
    if scheme == "cq-ggadmm":
        # past the flip: C2's gate on the cumulative bits
        bits, jbits = got["payload_bits"].sum(), want["payload_bits"].sum()
        assert abs(bits - jbits) <= 0.03 * jbits, (bits, jbits)


def test_cq_ggadmm_holds_jax_until_its_first_rounding_flip(work):
    """The window of the cq comparison: the port's own world-1 run follows
    the JAX dense run through iteration FLIP - 1 (theta at each iteration
    within the theta tolerance) and parts at FLIP, where the sharded runs
    part too (they equal the world-1 run bit for bit)."""
    x, y = np.load(work[0] / "x.npy"), np.load(work[0] / "y.npy")
    g = random_bipartite_graph(N_LIN, 0.4, seed=0)
    prob = LinearRegressionProblem(torch.from_numpy(x), torch.from_numpy(y))
    draws = np.load(work[0] / "linreg_draws.npy")
    _, out = E.run(g, ab.cq_ggadmm(rho=1.0), E.ExactSolver(prob),
                   torch.zeros((N_LIN, DIM)), ITERS, seed=SEED,
                   extra_metrics=E.flat_metrics(g, device="cpu"),
                   uniforms=lambda it, ph: torch.from_numpy(draws[it, ph]))
    theta = out["theta"].numpy()
    want = work[1]["linreg"]["cq-ggadmm"]["theta"]
    close = (np.abs(theta - want).max(axis=(1, 2))
             <= 1e-4 * np.abs(want).max())
    assert close[:FLIP].all() and not close[FLIP], close


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("scheme", SCHEMES)
def test_linreg_state_equals_the_world_one_run(work, world, scheme):
    per_rank = ranks(work, world)
    want = work[2]["linreg"][scheme]
    rows = [r["linreg"][scheme]["rows"] for r in per_rank]
    assert rows == [(i * N_LIN // world, (i + 1) * N_LIN // world)
                    for i in range(world)]
    for got in (r["linreg"][scheme] for r in per_rank):
        for k in ("tx_mask", "payload_bits", "theta", "trajectory", "q_hat"):
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        # all-reduced partial sums: another summation order
        np.testing.assert_allclose(got["primal_residual"],
                                   want["primal_residual"], rtol=1e-6)
        np.testing.assert_allclose(got["dual_residual"],
                                   want["dual_residual"], rtol=1e-6)


def test_pytree_inexact_solver_at_two_ranks(ranks2, work):
    want, world1 = work[1]["pytree"], work[2]["pytree"]
    for got in (r["pytree"] for r in ranks2):
        for k in ("w", "b"):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-5)
            np.testing.assert_array_equal(got[k], world1[k])
        assert got["consensus_err"] == pytest.approx(want["consensus_err"],
                                                     rel=1e-3)
        assert got["consensus_err"] == pytest.approx(
            world1["consensus_err"], rel=1e-6)


def test_regroup_picks_the_same_groups_on_every_rank(ranks2):
    """Each rank decides from the max over every rank's workers: the same
    groups on both, the JAX AutoGrouper's on the whole arrays. Alone, the
    ranks would pick different ones."""
    jag = JE.AutoGrouper(k=2, regroup_every=1)
    want = [jag.regroup({k: jnp.asarray(v) for k, v in th.items()},
                        {k: jnp.asarray(v) for k, v in q.items()})
            for th, q in regroup_trees()]
    got = [r["regroup"] for r in ranks2]
    assert got[0]["ids"] == got[1]["ids"] == want
    assert got[0]["local"] != got[1]["local"]


def test_regroup_every_in_the_trainer_at_two_ranks(ranks2):
    a, b = (r["lm_regroup"] for r in ranks2)
    assert a["history"] == b["history"] and a["n_groups"] == b["n_groups"]
    for x, y in zip(a["bits_per_group"], b["bits_per_group"]):
        np.testing.assert_array_equal(x, y)
    # step 1 regrouped to auto:2's two groups
    assert [w.shape[1] for w in a["bits_per_group"]][1:] == [2, 2]
    assert np.isfinite(a["history"]).all()


@pytest.mark.parametrize("quantize", [False, True], ids=["ggadmm",
                                                         "cq-ggadmm"])
def test_trainer_matches_the_jax_dense_run_admm(ranks2, work, quantize):
    jstate, jm = work[1]["lm"][quantize]
    jloss = [float(m["loss"]) for m in jm]
    a, b = (r["lm"][quantize] for r in ranks2)
    # every rank returns the same result
    assert a["history"] == b["history"]
    assert a["total_bits"] == b["total_bits"]
    if quantize:
        assert a["n_groups"] == len(a["theta"])
        for i in range(STEPS):
            np.testing.assert_array_equal(a["bits_per_group"][i],
                                          jm[i]["bits_per_group"])
        np.testing.assert_allclose(a["history"], jloss, atol=1e-3)
    else:
        jflat = [np.asarray(x) for x in
                 jax.tree_util.tree_leaves(jstate.theta)]
        scale = max(float(np.abs(x).max()) for x in jflat)
        err = np.concatenate([np.abs(g - w).ravel()
                              for g, w in zip(a["theta"], jflat)])
        assert (err > 1e-4 * scale).mean() <= 1e-4, (err > 1e-4 * scale).sum()
        assert err.max() <= 1e-3 * scale, err.max()
        np.testing.assert_allclose(a["history"], jloss, rtol=1e-4)
        assert a["total_bits"] == sum(float(m["payload_bits"].sum())
                                      for m in jm)
    # against the port's world-1 run: theta and bits bit for bit, the loss
    # a mean of the ranks' means
    world1 = work[2]["lm"][quantize]
    for g, w in zip(a["theta"], world1["theta"]):
        np.testing.assert_array_equal(g, w)
    assert a["total_bits"] == world1["total_bits"]
    np.testing.assert_allclose(a["history"], world1["history"], rtol=1e-6)


def test_pod_pair_at_two_ranks_is_the_world_one_run(ranks2, work):
    want = work[2]["pod_pair"]
    for got in (r["pod_pair"] for r in ranks2):
        assert got["total_bits"] == want["total_bits"]
        assert got["tx_counts"] == want["tx_counts"]
        np.testing.assert_allclose(got["history"], want["history"],
                                   rtol=1e-6)


@pytest.mark.parametrize("world", [2, 4])
def test_what_more_ranks_refuse(work, world):
    msgs = ranks(work, world)[0]["refusals"]
    assert "world size 1 only" in msgs["fleet"] and "ROADMAP" in msgs["fleet"]
    assert f"workers (9) divisible by the process group's world size " \
           f"({world})" in msgs["divisible"]


def test_torchrun_trainer_writes_the_world_one_checkpoint(tmp_path):
    """``python -m torch.distributed.run --standalone --nproc-per-node 2 -m
    repro_torch.launch.train --device cpu --mix-backend sharded``: rank 0
    alone prints and writes the checkpoint, which equals the world-1
    run's, file for file."""
    flags = ["--smoke", "--workers", "4", "--batch", "4", "--seq", "16",
             "--steps", "2", "--log-every", "1", "--device", "cpu",
             "--mix-backend", "sharded"]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "repro_torch.launch.train", *flags,
         "--ckpt-dir", str(tmp_path / "two")], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-3000:]
    assert proc.stdout.count("step    1  loss=") == 1, proc.stdout
    assert "ranks=2" in proc.stdout
    one = train.main(flags + ["--ckpt-dir", str(tmp_path / "one")])
    assert not dist.is_initialized()
    assert f"loss={one['history'][-1]:.4f}" in proc.stdout
    files = sorted(p.name for p in (tmp_path / "two").iterdir())
    assert files == sorted(p.name for p in (tmp_path / "one").iterdir())
    assert files == ["step_2.json", "step_2.npz"]
    for name in files:
        assert (tmp_path / "two" / name).read_bytes() == (
            tmp_path / "one" / name).read_bytes(), name
