"""The port's fleet simulator (``repro_torch.fleet``) against the JAX
package's ``repro.fleet`` and against its own synchronous engine.

On the ``linreg`` fixture of ``tests/test_fleet.py`` (6 workers, d=12 in two
leaves, p=0.4):

* ``faults.py`` is a numpy copy: the same draws as the original for 20
  seeds, bit for bit; so are ``staleness_trace`` and the remap of a fleet
  state across churn (up to 1e-6 where the joiners' mean is taken in
  float32 by two frameworks).
* a fault-free fleet is bit-identical to the port's ``run_synchronous``
  (dense and sparse backends x global and group censoring): every metric
  and the final theta, theta_hat and alpha.
* a faulted fleet (participation 0.6, staleness 2) against the JAX
  ``FleetSim`` with the JAX draws injected: ``tx_mask``, ``fleet_timer``
  and ``payload_bits`` equal, theta within 1e-4 max|theta*|. The two sum
  the sparse mix in other orders and solve with other LAPACKs, which moves
  theta by float32 rounding only.
* churn: the duals after each remap lie in ``col(M_-)`` of the new graph.
* a worker that timed out is charged zero bits.

And the LM trainer (xlstm-smoke, float32, 4 workers, seq 16) with
``--fleet --mix-backend sparse`` against the JAX package's ``run_fleet``
from the same parameters, to the tolerances of
``tests/test_torch_consensus.py``: unquantized, the loss within rel 1e-4
and the total bits equal; cq-ggadmm with the JAX draws injected, the loss
within 1e-3.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

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
from repro_torch.core import dynamic as D
from repro_torch.core import engine as E
from repro_torch.core import tree as T
from repro_torch.core.censoring import CensorConfig
from repro_torch.core.graph import membership_graph, random_bipartite_graph
from repro_torch.core.quantization import QuantConfig
from repro_torch.data import regression as R
from repro_torch.fleet import faults
from repro_torch.fleet import sim
from repro_torch.launch import train

N, DIM, ROUNDS = 6, 12, 10


@pytest.fixture(scope="module")
def linreg():
    x, y = R.partition_uniform(R.synth_linear(n=N * 30, d=DIM, seed=0), N)
    return dict(graph=random_bipartite_graph(N, 0.4, seed=0), x=x, y=y,
                prob=interop.problem_from_numpy(x, y, "linear", device="cpu"),
                jprob=JaxLinear(jnp.asarray(x), jnp.asarray(y)))


def cfgs(groups="leaf", censor_mode="global", mix_backend="sparse",
         censor=True):
    kw = dict(groups=groups, censor_mode=censor_mode,
              mix_backend=mix_backend, rho=1.0)
    return (E.EngineConfig(
        censor=CensorConfig(tau0=0.5, xi=0.97) if censor else CensorConfig(),
        quantize=QuantConfig(b0=2, omega=0.99), **kw),
        JE.EngineConfig(
        censor=JCensor(tau0=0.5, xi=0.97) if censor else JCensor(),
        quantize=JQuant(b0=2, omega=0.99), **kw))


def theta0(n=N):
    # two leaves, so groups="leaf" has G = 2
    return {"w": torch.zeros((n, DIM - 4)), "b": torch.zeros((n, 4))}


def jax_theta0(n=N):
    return {"w": jnp.zeros((n, DIM - 4), jnp.float32),
            "b": jnp.zeros((n, 4), jnp.float32)}


def jax_draws(seed):
    """The JAX FleetSim's packed draws: round r's key ``fold_in(PRNGKey
    (seed), r)``, split into one key per engine phase."""
    base_key = jax.random.PRNGKey(seed)

    def uniforms(r, phase, n, dim):
        k = jax.random.split(jax.random.fold_in(base_key, r))[phase]
        return torch.from_numpy(np.array(
            jax.random.uniform(k, (n, dim), jnp.float32)))
    return uniforms


# ---------------------------------------------------------- fault copy --
def test_fault_schedule_copy_draws_as_the_original():
    for seed in range(20):
        kw = dict(participation=0.3 + 0.03 * seed, skew=0.1 * (seed % 3),
                  staleness=seed % 4, stale_frac=0.5 + 0.02 * seed,
                  churn=(faults.ChurnEvent(round=2, leave=2, join=1),),
                  seed=seed)
        a = faults.FaultSchedule(faults.FaultConfig(**kw))
        jkw = dict(kw, churn=(jfaults.ChurnEvent(round=2, leave=2, join=1),))
        b = jfaults.FaultSchedule(jfaults.FaultConfig(**jkw))
        gids = list(range(3, 10))
        for r in range(6):
            fa, fb = a.round_faults(r, gids), b.round_faults(r, gids)
            np.testing.assert_array_equal(fa.drop, fb.drop)
            np.testing.assert_array_equal(fa.lag, fb.lag)
            assert fa.drop.dtype == fb.drop.dtype
            assert fa.lag.dtype == fb.lag.dtype
            assert a.pick_leavers(r, gids, 3) == b.pick_leavers(r, gids, 3)
        assert [a.worker_rate(g) for g in gids] == [b.worker_rate(g)
                                                    for g in gids]
        assert a.churn_at(2) == faults.ChurnEvent(2, 2, 1)
        assert a.churn_at(1) is None
    assert faults.FaultConfig().fault_free


def test_staleness_trace_copy_and_mirror(linreg):
    rng = np.random.default_rng(5)
    drops = (rng.uniform(size=(20, 5)) < 0.3).astype(np.float32)
    lags = np.where(rng.uniform(size=(20, 5)) < 0.3,
                    rng.integers(1, 4, size=(20, 5)), 0).astype(np.int32)
    offered = (rng.uniform(size=(20, 5)) < 0.8).astype(np.float32)
    for got, want in zip(faults.staleness_trace(drops, lags, offered),
                         jfaults.staleness_trace(drops, lags, offered)):
        np.testing.assert_array_equal(got, want)
    # the automaton of the port's fleet step, round for round (no
    # censoring, so every started buffer is offered)
    cfg, _ = cfgs("model", censor=False)
    fc = faults.FaultConfig(participation=0.5, staleness=3, seed=3)
    fsim = sim.FleetSim(N, cfg, sim.FleetConfig(rounds=14, faults=fc),
                        theta0(), solver=E.ExactSolver(linreg["prob"]),
                        graph0=linreg["graph"])
    _, m = fsim.run()
    rfs = [fsim.schedule.round_faults(r, list(range(N))) for r in range(14)]
    part, deliver, timers = faults.staleness_trace(
        np.stack([rf.drop for rf in rfs]), np.stack([rf.lag for rf in rfs]))
    np.testing.assert_array_equal(part, m["fleet_participation"])
    np.testing.assert_array_equal(deliver, m["fleet_deliver"])
    np.testing.assert_array_equal(timers, m["fleet_timer"])


def test_membership_graph_down_to_two():
    for n in range(6, 1, -1):
        g = membership_graph(n, 0.4, seed=0, epoch=6 - n)
        g.validate()
        assert g.n == n and int(g.head_mask.sum()) == n // 2
    assert membership_graph(2, 0.4, seed=0, epoch=9).num_edges == 1


# ------------------------------------------------------------- golden --
@pytest.mark.parametrize("censor_mode", ["global", "group"])
@pytest.mark.parametrize("mix_backend", ["dense", "sparse"])
def test_faultfree_fleet_bit_identical_to_run_synchronous(
        linreg, censor_mode, mix_backend):
    cfg, _ = cfgs("leaf", censor_mode, mix_backend)
    solver = E.ExactSolver(linreg["prob"])
    sync_state, sync_m = sim.run_synchronous(linreg["graph"], cfg, solver,
                                             theta0(), ROUNDS, seed=3)
    fsim = sim.FleetSim(N, cfg, sim.FleetConfig(rounds=ROUNDS, seed=3),
                        theta0(), solver=solver, graph0=linreg["graph"])
    fs, m = fsim.run()
    for k in sync_m:
        np.testing.assert_array_equal(m[k], sync_m[k], err_msg=k)
    for name in ("theta", "theta_hat", "alpha"):
        for a, b in zip(T.leaves(getattr(fs.engine, name)),
                        T.leaves(getattr(sync_state, name))):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert (m["fleet_participation"] == 1.0).all()
    assert (m["fleet_deliver"] == 0.0).all()
    assert (m["payload_bits_total"] > 0).all()


# ---------------------------------------------------- against the JAX --
def run_pair(linreg, fc_kw, rounds, groups="leaf", censor_mode="global",
             **fleet_kw):
    cfg, jcfg = cfgs(groups, censor_mode, "sparse")
    jfc = jsim.FleetConfig(rounds=rounds, seed=2, **fleet_kw,
                           faults=jfaults.FaultConfig(**fc_kw))
    jfs, jm = jsim.FleetSim(N, jcfg, jfc, jax_theta0(),
                            solver=JE.ExactSolver(linreg["jprob"]),
                            graph0=linreg["graph"]).run()
    draws = jax_draws(2)
    fc = sim.FleetConfig(rounds=rounds, seed=2, **fleet_kw,
                         faults=faults.FaultConfig(**fc_kw))
    fs, m = sim.FleetSim(
        N, cfg, fc, theta0(), solver=E.ExactSolver(linreg["prob"]),
        graph0=linreg["graph"],
        uniforms=lambda r, ph: draws(r, ph, N, DIM)).run()
    return (fs, m), (jfs, jm)


@pytest.mark.parametrize("censor_mode", ["global", "group"])
def test_faulted_fleet_matches_jax_fleetsim(linreg, censor_mode):
    (fs, m), (jfs, jm) = run_pair(
        linreg, dict(participation=0.6, staleness=2, seed=1), 8,
        censor_mode=censor_mode)
    assert (m["fleet_participation"] == 0).any()
    assert (m["fleet_deliver"] > 0).any()
    for k in ("tx_mask", "fleet_timer", "fleet_participation",
              "fleet_deliver", "fleet_start", "payload_bits", "censor_mask",
              "payload_bits_total"):
        np.testing.assert_array_equal(m[k], np.asarray(jm[k]), err_msg=k)
    star = np.abs(np.asarray(linreg["jprob"].optimum())).max()
    for name in ("theta", "theta_hat", "alpha"):
        got = E._flatten_worker(getattr(fs.engine, name)).numpy()
        want = np.asarray(JE._flatten_worker(getattr(jfs.engine, name)))
        assert np.abs(got - want).max() <= 1e-4 * star, name
    np.testing.assert_array_equal(fs.timer.numpy(), np.asarray(jfs.timer))


def test_timed_out_worker_is_charged_zero_bits(linreg):
    cfg, _ = cfgs("leaf", "group")
    fc = faults.FaultConfig(participation=0.5, staleness=2, seed=1)
    _, m = sim.FleetSim(N, cfg, sim.FleetConfig(rounds=16, faults=fc),
                        theta0(), solver=E.ExactSolver(linreg["prob"]),
                        graph0=linreg["graph"]).run()
    payload, tx = m["payload_bits"], m["tx_mask"]
    assert (tx == 0).any()
    assert (payload[tx == 0] == 0).all()
    np.testing.assert_array_equal(m["payload_bits_total"],
                                  np.sum(payload * (tx > 0), axis=1))
    dark = m["fleet_participation"] == 0
    deliver = m["fleet_deliver"] > 0
    assert dark.any() and (payload[dark & ~deliver] == 0).all()
    # it still offered bits where its censor test passed
    assert (m["offered_payload_bits"][dark & (m["censor_mask"] > 0)]
            > 0).all()


# --------------------------------------------------------------- churn --
def fleet_leaves(fs):
    """The arrays of a fleet state (either package), in one order."""
    st, q = fs.engine, fs.engine.quant
    trees = (st.theta, st.theta_hat, st.alpha, q.q_hat, fs.held_hat)
    out = [t[k] for t in trees for k in ("b", "w")]
    return out + [q.range_prev, q.bits_prev, q.delta_prev, q.initialized,
                  fs.held_payload, fs.timer]


def test_churn_remap_matches_jax_and_keeps_duals_in_col_space(linreg):
    rng = np.random.default_rng(0)
    shapes = {"w": (N, DIM - 4), "b": (N, 4)}

    def tree():
        return {k: rng.normal(size=s).astype(np.float32)
                for k, s in shapes.items()}
    arrays = dict(theta=tree(), theta_hat=tree(), alpha=tree(), q_hat=tree(),
                  held=tree())
    side = {k: rng.uniform(size=(N, 2)).astype(np.float32)
            for k in ("range_prev", "bits_prev", "delta_prev")}
    timer = np.array([0, 2, 0, 1, 0, 0], np.int32)
    held_payload = rng.uniform(size=N).astype(np.float32)
    cfg, jcfg = cfgs()

    def build(to, mod, eng):
        tr = lambda t: {k: to(v) for k, v in t.items()}  # noqa: E731
        quant = eng.GroupQuantState(
            q_hat=tr(arrays["q_hat"]), initialized=to(np.ones((N, 2),
                                                              np.float32)),
            **{k: to(v) for k, v in side.items()})
        st = eng.EngineState(theta=tr(arrays["theta"]),
                             theta_hat=tr(arrays["theta_hat"]),
                             alpha=tr(arrays["alpha"]), quant=quant,
                             opt_mu=(), opt_nu=(), k=3)
        return mod.FleetState(engine=st, held_hat=tr(arrays["held"]),
                              held_payload=to(held_payload), timer=to(timer))
    idx = np.array([0, 2, 3, -1, 5, -1], np.int32)
    g = membership_graph(6, 0.4, seed=0, epoch=1)
    for join_init in ("mean", "zeros"):
        for dual in ("zero", "project"):
            got = sim.remap_fleet_state(build(torch.from_numpy, sim, E), idx,
                                        g, cfg, join_init, dual)
            want = jsim.remap_fleet_state(build(jnp.asarray, jsim, JE), idx,
                                          g, jcfg, join_init, dual)
            for a, b in zip(fleet_leaves(got), fleet_leaves(want)):
                np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                           rtol=0, atol=1e-6)
            assert got.engine.opt_mu == () and got.engine.k == 3
            assert D.dual_in_col_space(got.engine.alpha, g)
    with pytest.raises(ValueError):
        sim.remap_fleet_state(build(torch.from_numpy, sim, E), idx, g, cfg,
                              "nope")


def test_churn_events_remap_the_running_fleet(linreg):
    cfg, _ = cfgs("leaf", "group")
    checks = []

    def on_churn(r, graph, fs):
        graph.validate()
        checks.append((r, graph.n, D.dual_in_col_space(fs.engine.alpha,
                                                        graph)))

    def solver_factory(members, graph):
        rows = np.asarray([int(gid) % N for gid in members])
        return E.ExactSolver(interop.problem_from_numpy(
            linreg["x"][rows], linreg["y"][rows], "linear", device="cpu"))

    fc = faults.FaultConfig(participation=0.8, staleness=1, seed=4, churn=(
        faults.ChurnEvent(round=4, leave=2, join=1),
        faults.ChurnEvent(round=8, leave=1, join=0)))
    fsim = sim.FleetSim(N, cfg, sim.FleetConfig(rounds=12, faults=fc),
                        theta0(), solver_factory=solver_factory,
                        graph0=linreg["graph"], on_churn=on_churn)
    fs, m = fsim.run()
    assert [c[:2] for c in checks] == [(4, 5), (8, 4)]
    assert all(ok for *_, ok in checks)
    assert m["n_members"].tolist() == [6] * 4 + [5] * 4 + [4] * 4
    assert T.leaves(fs.engine.theta)[0].shape[0] == 4
    assert fsim.topo.backend == "sparse" and fsim.topo.n == 4
    assert float(fs.engine.quant.initialized.sum()) > 0
    with pytest.raises(ValueError):
        sim.FleetSim(N, cfg, sim.FleetConfig(rounds=1), theta0())


# ------------------------------------------------------ the LM trainer --
LM_N, LM_BATCH, LM_SEQ, LM_ROUNDS = 4, 4, 16, 3
FLEET = dict(participation=0.75, staleness=2, stale_frac=1.0, churn=(),
             seed=0)


def lm_flags(quantize):
    return ["--arch", "xlstm-125m", "--smoke", "--workers", str(LM_N),
            "--batch", str(LM_BATCH), "--seq", str(LM_SEQ), "--steps",
            str(LM_ROUNDS), "--local-steps", "2", "--lr", "2e-3", "--xi",
            "0.999", "--bits", "6", "--omega", "0.9995", "--groups", "leaf",
            "--device", "cpu", "--log-every", "1", "--mix-backend", "sparse",
            "--fleet", "--fleet-participation", "0.75",
            "--fleet-staleness", "2"] + (
        ["--tau0", "5.0"] if quantize else ["--no-quantize", "--tau0", "0"])


def jax_run_fleet(jcfg, quantize):
    """The JAX package's ``run_fleet`` at the same settings, float32."""
    graph = JST.worker_graph(LM_N, "random")
    ecfg = JE.EngineConfig(
        rho=0.01, censor=JCensor(tau0=5.0, xi=0.999) if quantize
        else JCensor(), quantize=JQuant(b0=6, omega=0.9995)
        if quantize else None, groups="leaf", mix_backend="sparse")

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
        fleet_participation=FLEET["participation"],
        fleet_staleness=FLEET["staleness"],
        fleet_stale_frac=FLEET["stale_frac"], fleet_churn="",
        fleet_seed=FLEET["seed"], ckpt_dir=None)
    data = jlm.SyntheticLM(jlm.SyntheticLMConfig(jcfg.vocab_size, LM_SEQ))
    out = jtrain.run_fleet(jcfg, args, graph, ecfg, solver, loss_fn, params,
                           data)
    return one, out


def run_lm_both(quantize):
    jcfg = jbase.get_smoke_config("xlstm-125m").with_overrides(
        dtype="float32")
    one, jout = jax_run_fleet(jcfg, quantize)
    params = interop.tree_from_numpy(
        {jax.tree_util.keystr(p): np.asarray(x) for p, x in
         jax.tree_util.tree_flatten_with_path(one)[0]}, device="cpu")
    cfg = base.get_smoke_config("xlstm-125m").with_overrides(dtype="float32")
    args = train.build_parser().parse_args(lm_flags(quantize))
    dim = sum(x.numel() for x in T.leaves(params))
    draws = jax_draws(0)
    out = train.run_admm(cfg, args, params=params,
                         uniforms=lambda r, ph: draws(r, ph, LM_N, dim))
    return out, jout


def test_lm_fleet_sparse_matches_jax_trainer():
    out, jout = run_lm_both(False)
    assert (out["metrics"]["fleet_participation"] == 0).any()
    np.testing.assert_allclose(out["history"], jout["history"], rtol=1e-4)
    assert out["total_bits"] == jout["total_bits"]
    # a dark worker is charged nothing (32-bit payloads otherwise)
    m = out["metrics"]
    dark = (m["fleet_participation"] == 0) & (m["fleet_deliver"] == 0)
    assert (m["payload_bits"][dark] == 0).all()


def test_lm_fleet_sparse_cq_matches_jax_trainer_with_injected_draws():
    out, jout = run_lm_both(True)
    assert out["n_groups"] == 19 == jout["n_groups"]
    np.testing.assert_allclose(out["history"], jout["history"], atol=1e-3)
    assert np.isfinite(out["history"]).all()
