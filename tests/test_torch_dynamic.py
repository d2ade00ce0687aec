"""The port's time-varying topology (``repro_torch.core.dynamic``) against
the JAX package's ``repro.core.dynamic``: the dual column-space helpers and
``run_dynamic`` on a 12-worker synth-linear problem (d=16, p=0.4, a new
graph every 10 iterations), on the dense and sparse backends.

Tolerances and their reasons:

* dual helpers: ``reinit_duals``/``project_duals`` within 1e-6 (float32
  means over the worker axis in two frameworks); ``dual_in_col_space``
  gives the same verdict.
* ggadmm (deterministic): the final theta, theta_hat and alpha within
  tol = 1e-4 max|theta*| after 15 and 40 iterations (across three
  refreshes); at every iteration the objective within rel 1e-5 and the
  square roots of the distance to the optimum and of the primal residual
  (norms of worker-stacked differences) within what an elementwise
  agreement to tol allows; ``tx_mask`` equal. Both sides solve in float32
  with different LAPACKs.
* cq-ggadmm with the JAX draws injected (``uniforms=``): a stochastic
  rounding decision flips wherever ``|frac(c) - u|`` is below the solves'
  rounding, and from then on the runs are two samples of one chain (as in
  ``test_torch_engine.py``). So: ``tx_mask`` equal over the first 40
  iterations (the first censor flip here is at 41), the distance to the
  optimum within rel 1e-5 over the first 5, the cumulative bits within
  3% (the engine test's gate), and both runs converging.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import admm_baselines as jab
from repro.core import dynamic as JD
from repro.core.graph import membership_graph as jmembership
from repro.core.graph import random_bipartite_graph as jrandom
from repro.core.solvers import LinearRegressionProblem as JaxLinear
from repro_torch import interop
from repro_torch.core import admm_baselines as ab
from repro_torch.core import dynamic as D
from repro_torch.core.graph import membership_graph, random_bipartite_graph
from repro_torch.data import regression as R

NW, DIM, REFRESH = 12, 16, 10
CQ = dict(rho=1.0, tau0=0.5, xi=0.97)


@pytest.fixture(scope="module")
def problem():
    x, y = R.partition_uniform(R.synth_linear(n=600, d=DIM, seed=3), NW)
    prob = interop.problem_from_numpy(x, y, "linear", device="cpu")
    jprob = JaxLinear(jnp.asarray(x), jnp.asarray(y))
    return prob, jprob, np.asarray(jprob.optimum())


def jax_uniforms(seed, iters):
    """The JAX ``run_dynamic``'s draws: per topology phase p the keys
    ``split(fold_in(PRNGKey(seed), p), span)``, per iteration ``k1, k2 =
    split(key)`` and ``uniform(k, (N, dim))`` per engine phase. Returns
    (iters, 2, N, dim)."""
    def one(key):
        k1, k2 = jax.random.split(key)
        return jnp.stack([jax.random.uniform(k1, (NW, DIM), jnp.float32),
                          jax.random.uniform(k2, (NW, DIM), jnp.float32)])
    base = jax.random.PRNGKey(seed)
    keys = [jax.random.split(jax.random.fold_in(base, p),
                             min(REFRESH, iters - p * REFRESH))
            for p in range(-(-iters // REFRESH))]
    return np.asarray(jax.vmap(one)(jnp.concatenate(keys)))


def run_both(problem, scheme, backend, iters, uniforms=None):
    prob, jprob, jstar = problem
    jcfg = dataclasses.replace(getattr(jab, scheme)(**(
        CQ if scheme == "cq_ggadmm" else dict(rho=1.0))), mix_backend=backend)
    cfg = dataclasses.replace(getattr(ab, scheme)(**(
        CQ if scheme == "cq_ggadmm" else dict(rho=1.0))), mix_backend=backend)
    jstate, jout = JD.run_dynamic(
        JD.DynamicTopology(NW, p=0.4, refresh_every=REFRESH, seed=1), jprob,
        jcfg, DIM, iters, seed=0, theta_star=jnp.asarray(jstar),
        local_loss=jprob.local_loss)
    hook = None if uniforms is None else (
        lambda it, ph: torch.from_numpy(uniforms[it, ph].copy()))
    state, out = D.run_dynamic(
        D.DynamicTopology(NW, p=0.4, refresh_every=REFRESH, seed=1), prob,
        cfg, DIM, iters, seed=0, theta_star=prob.optimum(),
        local_loss=prob.local_loss, uniforms=hook, device="cpu")
    return (state, out), (jstate, {k: np.asarray(v) for k, v in jout.items()})


@pytest.mark.parametrize("backend", ["dense", "sparse"])
@pytest.mark.parametrize("iters", [15, 40])
def test_ggadmm_run_dynamic_matches_jax(problem, backend, iters):
    (state, out), (jstate, jout) = run_both(problem, "ggadmm", backend,
                                            iters)
    tol = 1e-4 * np.abs(problem[2]).max()
    for name in ("theta", "theta_hat", "alpha"):
        err = np.abs(getattr(state, name).numpy()
                     - np.asarray(getattr(jstate, name))).max()
        assert err <= tol, (name, err, tol)
    assert set(out) == set(jout)
    np.testing.assert_array_equal(out["tx_mask"], jout["tx_mask"])
    np.testing.assert_array_equal(out["payload_bits"], jout["payload_bits"])
    np.testing.assert_allclose(out["objective"], jout["objective"],
                               rtol=1e-5)
    # the square roots are norms of stacked differences: elementwise
    # agreement within tol bounds them by sqrt(N d) tol, and by
    # 2 sqrt(E d) tol for the E <= N^2 edges of the residual
    for k, bound in (("dist_to_opt", np.sqrt(NW * DIM) * tol),
                     ("primal_residual", 2.0 * np.sqrt(NW * NW * DIM) * tol)):
        err = np.abs(np.sqrt(out[k]) - np.sqrt(jout[k]))
        assert (err <= bound).all(), (k, err.max(), bound)


@pytest.mark.parametrize("backend", ["dense", "sparse"])
def test_cq_ggadmm_run_dynamic_with_injected_uniforms(problem, backend):
    iters = 40
    (_, out), (_, jout) = run_both(problem, "cq_ggadmm", backend, iters,
                                   uniforms=jax_uniforms(0, iters))
    np.testing.assert_array_equal(out["tx_mask"], jout["tx_mask"])
    np.testing.assert_allclose(out["dist_to_opt"][:5],
                               jout["dist_to_opt"][:5], rtol=1e-5)
    bits, jbits = out["payload_bits"].sum(), jout["payload_bits"].sum()
    assert abs(bits / jbits - 1.0) <= 0.03, (bits, jbits)
    for o in (out, jout):
        assert o["dist_to_opt"][-1] < 0.1 * o["dist_to_opt"][0]
        sent = o["payload_bits"][o["tx_mask"] > 0]
        assert (sent < 32 * DIM).all()     # quantized payloads


def test_run_dynamic_seeded_draws_are_reproducible(problem):
    prob = problem[0]
    topo = D.DynamicTopology(NW, p=0.4, refresh_every=5, seed=2)
    cfg = ab.cq_ggadmm(**CQ)
    a = D.run_dynamic(topo, prob, cfg, DIM, 12, seed=4, device="cpu")[1]
    b = D.run_dynamic(topo, prob, cfg, DIM, 12, seed=4, device="cpu")[1]
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
    assert D.DynamicTopology(NW).graph_at(0).n == NW


def _alpha(n, seed):
    rng = np.random.default_rng(seed)
    return {"w": rng.normal(size=(n, 9)).astype(np.float32),
            "b": rng.normal(size=(n, 3)).astype(np.float32)}


def test_dual_helpers_match_jax():
    alpha = _alpha(10, 3)
    g = random_bipartite_graph(10, 0.4, seed=2)
    jg = jrandom(10, 0.4, seed=2)
    t_alpha = {k: torch.from_numpy(v) for k, v in alpha.items()}
    j_alpha = {k: jnp.asarray(v) for k, v in alpha.items()}
    for mode in ("zero", "project"):
        got = D.reinit_duals(t_alpha, g, mode=mode)
        want = JD.reinit_duals(j_alpha, jg, mode=mode)
        for k in alpha:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                       rtol=0, atol=1e-6)
        assert D.dual_in_col_space(got, g) and JD.dual_in_col_space(want, jg)
    assert not D.dual_in_col_space(t_alpha, g)
    assert not JD.dual_in_col_space(j_alpha, jg)
    proj = D.project_duals(t_alpha, g)
    again = D.project_duals(proj, g)
    for k in alpha:
        np.testing.assert_allclose(proj[k].numpy(), again[k].numpy(),
                                   atol=1e-6)
    other, jother = membership_graph(10, 0.5, seed=7), jmembership(
        10, 0.5, seed=7)
    assert D.dual_in_col_space(proj, other)
    assert JD.dual_in_col_space(JD.project_duals(j_alpha, jg), jother)
    with pytest.raises(ValueError):
        D.reinit_duals(t_alpha, g, mode="nope")


def test_duals_in_col_space_after_refresh(problem):
    """Through run_dynamic's refreshes the duals stay in col(M_-) of the
    last graph: the refresh re-init and the Laplacian dual update (into
    1^⊥) keep the Thm-3 condition."""
    prob = problem[0]
    topo = D.DynamicTopology(NW, p=0.4, refresh_every=5, seed=2)
    state, _ = D.run_dynamic(topo, prob, ab.ggadmm(rho=1.0), DIM, 20,
                             device="cpu")
    assert D.dual_in_col_space(state.alpha, topo.graph_at(3), atol=1e-3)
    assert float(state.alpha.abs().max()) > 0.0
