"""The main-path gate: the port's engine against the JAX package's on the
paper's quickstart part 1 (24 workers, synth-linear d=50, p=0.35, seed 0).

Tolerances and their reasons:

* Deterministic schemes (ggadmm, c-ggadmm, c-admm): theta trajectories
  within 1e-4 max|theta*| at every iteration. Both sides solve in float32
  with different LAPACKs; the difference stays at the solves' rounding.
* A ``tx_mask`` entry may differ only where the censor test sits on its
  boundary, ``| ||candidate - theta_hat|| - tau | <= 1e-5 tau``.
* cq-ggadmm, with the JAX draws injected as uniforms: a stochastic
  rounding decision flips wherever ``|frac(c) - u|`` is below the solves'
  rounding (first at iteration 10 here), and from then on the two runs are
  different samples of the same chain. Over 12 seeds
  (``tests/torch_bits_spread.py``, on the CPU) the reference's own bit
  total moves by up to 1.32% when its input is scaled by one float32 ulp,
  and the port with MKL's float32 ``torch.linalg.solve`` sits +1.32% above
  the reference on average (at most +2.21%, seed 0): the bit widths reach
  b_max sooner above its rounding floor (with a float64 solve: -0.47%). So
  the cumulative bits are held to 3% of the reference, and the
  trajectories to the deterministic tolerance until the first flip.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import admm_baselines as jab
from repro.core import engine as JE
from repro.core.graph import random_bipartite_graph as jax_graph
from repro.core.solvers import LinearRegressionProblem as JaxLinear
from repro_torch import interop
from repro_torch.core import admm_baselines as ab
from repro_torch.core import censoring as cens
from repro_torch.core import cq_ggadmm
from repro_torch.core import engine as E
from repro_torch.core.comm import build_comm_log
from repro_torch.core.graph import random_bipartite_graph
from repro_torch.data import regression as R

N, D, ITERS = 24, 50, 300


@pytest.fixture(scope="module")
def setup():
    x, y = R.partition_uniform(R.synth_linear(), N)
    prob = interop.problem_from_numpy(x, y, "linear", device="cpu")
    jprob = JaxLinear(jnp.asarray(x), jnp.asarray(y))
    return dict(graph=random_bipartite_graph(N, 0.35, seed=0),
                jgraph=jax_graph(N, 0.35, seed=0), prob=prob, jprob=jprob,
                theta_star=prob.optimum(),
                jstar=np.asarray(jprob.optimum()))


def jax_uniforms(seed, iters, n=N, d=D):
    """The JAX engine's draws for a one-leaf tree: ``keys = split(PRNGKey
    (seed), iters)``, ``k1, k2 = split(key)`` per iteration, one
    ``uniform(k, (N, d))`` per phase. Returns (iters, 2, N, d)."""
    def one(key):
        k1, k2 = jax.random.split(key)
        return jnp.stack([jax.random.uniform(k1, (n, d), jnp.float32),
                          jax.random.uniform(k2, (n, d), jnp.float32)])
    keys = jax.random.split(jax.random.PRNGKey(seed), iters)
    return np.asarray(jax.jit(jax.vmap(one))(keys))


def run_jax(s, cfg, iters, seed=0):
    _, out = JE.run(s["jgraph"], cfg, JE.ExactSolver(s["jprob"]),
                    jnp.zeros((N, D), jnp.float32), iters, seed=seed,
                    extra_metrics=JE.flat_metrics(s["jgraph"]))
    return jax.tree_util.tree_map(np.asarray, out)


def run_port(s, cfg, iters, uniforms=None):
    """Step the port by hand so the censor test's margins are on record:
    per iteration, the change norm of every worker's candidate against its
    last transmitted value, and the threshold."""
    step = E.make_step(s["graph"], cfg, E.ExactSolver(s["prob"]),
                       extra_metrics=E.flat_metrics(s["graph"], device="cpu"),
                       device="cpu")
    state = E.init_state(torch.zeros((N, D)), cfg)
    gen = torch.Generator().manual_seed(0)
    history, norms, taus = [], [], []
    for it in range(iters):
        def draw(phase, it=it):
            if uniforms is not None:
                return torch.from_numpy(uniforms[it, phase].copy())
            return torch.rand((N, D), generator=gen)
        hat_before = state.theta_hat
        state, m = step(state, draw)
        cand = state.quant.q_hat if cfg.quantize is not None else state.theta
        norms.append(torch.linalg.vector_norm(cand - hat_before, dim=-1))
        taus.append(float(cens.threshold(cfg.censor, it + 1)))
        history.append(m)
    out = {k: torch.stack([m[k] for m in history]).numpy()
           for k in history[0]}
    return state, out, torch.stack(norms).numpy(), np.asarray(taus)


def assert_tx_masks_agree(port_tx, jax_tx, norms, taus):
    flips = port_tx != jax_tx
    margin = np.abs(norms - taus[:, None])
    assert (margin[flips] <= 1e-5 * np.broadcast_to(
        taus[:, None], flips.shape)[flips]).all(), (
        f"{flips.sum()} tx_mask flips away from the censor boundary")


def assert_trajectories_agree(port_theta, jax_theta, jstar):
    err = np.abs(port_theta - jax_theta).max(axis=(1, 2))
    tol = 1e-4 * np.abs(jstar).max()
    assert (err <= tol).all(), (
        f"trajectory error {err.max():.3e} at iteration {err.argmax()} "
        f"exceeds {tol:.3e}")


def dist_to_opt(theta_final, star):
    return float(((np.asarray(theta_final) - np.asarray(star)[None]) ** 2
                  ).sum())


def test_ggadmm_matches_jax(setup):
    s = setup
    want = run_jax(s, jab.ggadmm(rho=1.0), ITERS)
    _, got, norms, taus = run_port(s, ab.ggadmm(rho=1.0), ITERS)
    assert_trajectories_agree(got["theta"], want["theta"], s["jstar"])
    np.testing.assert_array_equal(got["tx_mask"], want["tx_mask"])
    assert dist_to_opt(got["theta"][-1], s["theta_star"]) < 1e-8
    log = build_comm_log(got["tx_mask"], got["payload_bits"], s["graph"],
                         fraction_active=0.5)
    assert log.cumulative_rounds[-1] == 7200
    assert log.cumulative_bits[-1] == 1.152e7
    np.testing.assert_array_equal(got["payload_bits"], want["payload_bits"])


def test_cq_ggadmm_matches_jax_with_injected_uniforms(setup):
    s = setup
    want = run_jax(s, jab.cq_ggadmm(rho=1.0), ITERS)
    _, got, norms, taus = run_port(s, ab.cq_ggadmm(rho=1.0), ITERS,
                                   uniforms=jax_uniforms(0, ITERS))
    assert_tx_masks_agree(got["tx_mask"], want["tx_mask"], norms, taus)
    log = build_comm_log(got["tx_mask"], got["payload_bits"], s["graph"],
                         fraction_active=0.5)
    jlog = build_comm_log(want["tx_mask"], want["payload_bits"],
                          s["jgraph"], fraction_active=0.5)
    assert log.cumulative_rounds[-1] == 7200
    assert jlog.cumulative_bits[-1] == pytest.approx(4.7752e6, rel=1e-4)
    assert log.cumulative_bits[-1] == pytest.approx(
        jlog.cumulative_bits[-1], rel=0.03)
    assert dist_to_opt(got["theta"][-1], s["theta_star"]) < 1e-8
    # before the first rounding flip the chains are the same chain
    assert_trajectories_agree(got["theta"][:8], want["theta"][:8],
                              s["jstar"])


@pytest.mark.parametrize("scheme,iters,kw", [
    ("c-admm", 100, {}),
    # censors about half the rounds; past ~85 iterations tau = 5 * 0.9^k
    # falls to within two orders of the runs' float32 agreement, and the
    # runs part at the first censor decision taken on that margin
    ("c-ggadmm", 80, dict(tau0=5.0, xi=0.9)),
])
def test_censored_schemes_match_jax(setup, scheme, iters, kw):
    s = setup
    want = run_jax(s, jab.ALL_SCHEMES[scheme](rho=1.0, **kw), iters)
    _, got, norms, taus = run_port(s, ab.ALL_SCHEMES[scheme](rho=1.0, **kw),
                                   iters)
    assert_trajectories_agree(got["theta"], want["theta"], s["jstar"])
    assert_tx_masks_agree(got["tx_mask"], want["tx_mask"], norms, taus)
    same = got["tx_mask"] == want["tx_mask"]
    np.testing.assert_array_equal(got["payload_bits"][same],
                                  want["payload_bits"][same])


def test_group_censor_mode_is_global_mode_at_one_group(setup):
    s = setup
    base = ab.cq_ggadmm(rho=1.0, tau0=5.0, xi=0.9)
    u = jax_uniforms(1, 30)
    _, glob, _, _ = run_port(s, base, 30, uniforms=u)
    _, grp, _, _ = run_port(s, dataclasses.replace(base, censor_mode="group"),
                            30, uniforms=u)
    np.testing.assert_array_equal(grp["tx_mask"], glob["tx_mask"])
    np.testing.assert_allclose(grp["theta"], glob["theta"], rtol=0, atol=0)


def test_one_step_from_a_carried_jax_state_matches_jax(setup):
    """Run JAX 20 iterations, carry its state across with ``interop``, and
    take one more step on both sides with the same uniforms."""
    s = setup
    cfg, jcfg = ab.cq_ggadmm(rho=1.0), jab.cq_ggadmm(rho=1.0)
    jstate, _ = JE.run(s["jgraph"], jcfg, JE.ExactSolver(s["jprob"]),
                       jnp.zeros((N, D), jnp.float32), 20)
    flat = {"theta": jstate.theta, "theta_hat": jstate.theta_hat,
            "alpha": jstate.alpha, "k": jstate.k}
    for f in interop.QUANT_FIELDS:
        flat[f"quant.{f}"] = getattr(jstate.quant, f)
    flat = {k: np.asarray(v) for k, v in flat.items()}
    state = interop.engine_state_from_numpy(flat, device="cpu")
    assert state.k == 20
    for k, v in interop.engine_state_to_numpy(state).items():
        np.testing.assert_array_equal(v, flat[k])

    key = jax.random.PRNGKey(123)
    k1, k2 = jax.random.split(key)
    u = [torch.from_numpy(np.array(jax.random.uniform(k, (N, D))))
         for k in (k1, k2)]
    jstep = jax.jit(JE.make_step(s["jgraph"], jcfg,
                                 JE.ExactSolver(s["jprob"])))
    jnext, jm = jstep(jstate, None, key)
    step = E.make_step(s["graph"], cfg, E.ExactSolver(s["prob"]),
                       device="cpu")
    nxt, m = step(state, lambda phase: u[phase])
    got = interop.engine_state_to_numpy(nxt)
    tol = 1e-4 * np.abs(s["jstar"]).max()
    np.testing.assert_allclose(got["theta"], np.asarray(jnext.theta),
                               rtol=0, atol=tol)
    np.testing.assert_array_equal(got["quant.bits_prev"],
                                  np.asarray(jnext.quant.bits_prev))
    for f in ("quant.q_hat", "theta_hat", "alpha"):
        want = np.asarray(jnext.quant.q_hat if f == "quant.q_hat"
                          else getattr(jnext, f))
        np.testing.assert_allclose(got[f], want, rtol=0, atol=tol)
    np.testing.assert_array_equal(m["tx_mask"].numpy(),
                                  np.asarray(jm["tx_mask"]))
    assert got["k"] == 21


def test_cq_ggadmm_adapter_run(setup):
    s = setup
    cfg = ab.cq_ggadmm(rho=1.0)
    _, out = cq_ggadmm.run(s["graph"], s["prob"], cfg, D, 40,
                           theta_star=s["theta_star"],
                           local_loss=s["prob"].local_loss,
                           uniforms=lambda it, ph: torch.rand((N, D)),
                           device="cpu")
    assert set(out) == {"tx_mask", "payload_bits", "candidate_payload_bits",
                        "primal_residual", "objective", "dist_to_opt"}
    assert out["dist_to_opt"].shape == (40,)
    assert out["dist_to_opt"][-1] < out["dist_to_opt"][0]
    assert np.isfinite(out["objective"]).all()


@pytest.mark.parametrize("kw", [dict(mix_backend="sharded"),
                                dict(hat_dtype="bfloat16"),
                                dict(hat_dtype="float16"),
                                dict(hat_dtype="float32", groups="leaf")])
def test_engine_config_refuses_what_is_not_ported(kw):
    with pytest.raises(NotImplementedError):
        E.EngineConfig(**kw)


def test_engine_config_accepts_the_sparse_backend(setup):
    """``mix_backend="sparse"`` runs (it was refused before the sparse
    topology was ported): ggadmm on the sparse backend follows the dense
    backend's trajectory, the two mixes differing by summation order."""
    s = setup
    _, dense, _, _ = run_port(s, ab.ggadmm(rho=1.0), 20)
    cfg = dataclasses.replace(ab.ggadmm(rho=1.0), mix_backend="sparse")
    _, sparse, _, _ = run_port(s, cfg, 20)
    assert_trajectories_agree(sparse["theta"], dense["theta"], s["jstar"])
    np.testing.assert_array_equal(sparse["tx_mask"], dense["tx_mask"])


def test_step_takes_the_fleet_participation_hook(setup):
    """The fleet's on-time mask (it was refused before the fleet was
    ported): all-ones is the synchronous step bit for bit; a timed-out
    worker transmits nothing and is charged zero bits, while its
    censor-only decision and offered bits are still reported."""
    s = setup
    cfg = ab.cq_ggadmm(rho=1.0)
    step = E.make_step(s["graph"], cfg, E.ExactSolver(s["prob"]),
                       device="cpu")
    u = jax_uniforms(2, 1)[0]

    def draw(phase):
        return torch.from_numpy(u[phase].copy())

    state = E.init_state(torch.zeros((N, D)), cfg)
    _, sync = step(state, draw)
    _, ones = step(state, draw, participation=torch.ones(N))
    for k in sync:
        torch.testing.assert_close(ones[k], sync[k], rtol=0, atol=0)
    part = torch.ones(N)
    part[[0, 5]] = 0.0
    _, m = step(state, draw, participation=part)
    assert float(m["tx_mask"][0]) == 0.0 and float(m["tx_mask"][5]) == 0.0
    assert float(m["payload_bits"][0]) == 0.0
    assert float(m["payload_bits"][5]) == 0.0
    torch.testing.assert_close(m["censor_mask"], sync["censor_mask"])
    torch.testing.assert_close(m["offered_payload_bits"],
                               sync["payload_bits"])
    torch.testing.assert_close(m["tx_mask"], sync["tx_mask"] * part)


@pytest.mark.parametrize("groups", ["model", "leaf", "block:attn,mlp",
                                    "block:embed,mlp,norm,rest", "auto:3",
                                    (0, 1), ((0, 1), (2,))], ids=str)
def test_engine_config_accepts_every_group_spec(groups):
    """Group specs are ported: each form is accepted as the JAX package
    accepts it (resolution against a tree is tested in
    test_torch_packing.py)."""
    cfg = E.EngineConfig(groups=groups)
    assert cfg.groups == JE.EngineConfig(groups=groups).groups


@pytest.mark.parametrize("groups", ["block:", "auto:0", "auto:x", "layer"])
def test_engine_config_refuses_malformed_group_specs(groups):
    with pytest.raises(E.GroupSpecError):
        E.EngineConfig(groups=groups)
    with pytest.raises(JE.GroupSpecError):
        JE.EngineConfig(groups=groups)


@pytest.mark.parametrize("scheme", ["ggadmm", "cq-ggadmm", "c-admm"])
def test_step_metric_keys_match_jax(setup, scheme):
    """Both packages' steps return the same metric keys; on the
    synchronous path censor_mask == tx_mask and offered == payload."""
    s = setup
    want = run_jax(s, jab.ALL_SCHEMES[scheme](rho=1.0), 2)
    _, got, _, _ = run_port(s, ab.ALL_SCHEMES[scheme](rho=1.0), 2)
    assert set(got) == set(want)
    np.testing.assert_array_equal(got["censor_mask"], got["tx_mask"])
    np.testing.assert_array_equal(got["offered_payload_bits"],
                                  got["payload_bits"])


def test_engine_config_names_and_defaults():
    assert E.EngineConfig() == E.EngineConfig(rho=1.0, alternating=True)
    names = {k: f().name for k, f in ab.ALL_SCHEMES.items()}
    assert names == {k: f().name for k, f in jab.ALL_SCHEMES.items()}
    with pytest.raises(ValueError):
        E.EngineConfig(censor_mode="local")
