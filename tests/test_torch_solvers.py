"""The port's local solvers against the JAX package's on the same data
(rtol 1e-5: float32 solves whose Gram sums run in another order)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import solvers as jsolvers
from repro_torch import interop
from repro_torch.core import solvers
from repro_torch.data import regression as data

RTOL = 1e-5


def linear_data(n_workers=6):
    x, y = data.partition_uniform(data.synth_linear(n=240, d=9, seed=3),
                                  n_workers)
    return x, y


def logistic_data(n_workers=6):
    x, y = data.partition_uniform(data.derm(), n_workers)
    return x, y


def solve_inputs(n, d, seed=0):
    rng = np.random.default_rng(seed)
    v = rng.standard_normal((n, d)).astype(np.float32)
    rho_d = rng.integers(1, 5, size=n).astype(np.float32)
    theta0 = (0.1 * rng.standard_normal((n, d))).astype(np.float32)
    return v, rho_d, theta0


def assert_close(got, want, rtol=RTOL):
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=rtol,
                               atol=rtol * np.abs(want).max())


def test_linear_primal_solve_and_optimum_match_jax():
    x, y = linear_data()
    prob = interop.problem_from_numpy(x, y, "linear", device="cpu")
    jprob = jsolvers.LinearRegressionProblem(jnp.asarray(x), jnp.asarray(y))
    v, rho_d, theta0 = solve_inputs(*x.shape[::2])
    got = prob.primal_solve(torch.from_numpy(v), torch.from_numpy(rho_d))
    assert_close(got, jprob.primal_solve(jnp.asarray(v), jnp.asarray(rho_d)))
    assert_close(prob.optimum(), jprob.optimum())
    th = torch.from_numpy(theta0)
    assert_close(prob.local_loss(th), jprob.local_loss(jnp.asarray(theta0)))
    assert_close(prob.global_loss(th[0]),
                 jprob.global_loss(jnp.asarray(theta0[0])))


def test_logistic_primal_solve_and_optimum_match_jax():
    x, y = logistic_data()
    prob = interop.problem_from_numpy(x, y, "logistic", device="cpu")
    jprob = jsolvers.LogisticRegressionProblem(jnp.asarray(x), jnp.asarray(y))
    v, rho_d, theta0 = solve_inputs(x.shape[0], x.shape[2], seed=1)
    got = prob.primal_solve(torch.from_numpy(v), torch.from_numpy(rho_d),
                            theta_init=torch.from_numpy(theta0))
    assert_close(got, jprob.primal_solve(jnp.asarray(v), jnp.asarray(rho_d),
                                         theta_init=jnp.asarray(theta0)))
    assert_close(prob.optimum(), jprob.optimum())
    th = torch.from_numpy(theta0)
    assert_close(prob.local_loss(th), jprob.local_loss(jnp.asarray(theta0)))
    assert_close(prob.global_loss(th[0]),
                 jprob.global_loss(jnp.asarray(theta0[0])))


def test_gradient_descent_solver_matches_jax():
    x, y = linear_data()
    prob = interop.problem_from_numpy(x, y, "linear", device="cpu")
    jprob = jsolvers.LinearRegressionProblem(jnp.asarray(x), jnp.asarray(y))

    def grad(th):
        return torch.einsum("nsd,ns->nd", prob.x,
                            torch.einsum("nsd,nd->ns", prob.x, th) - prob.y)

    def jgrad(th):
        return jnp.einsum("nsd,ns->nd", jprob.x,
                          jnp.einsum("nsd,nd->ns", jprob.x, th) - jprob.y)

    v, rho_d, theta0 = solve_inputs(*x.shape[::2], seed=2)
    got = solvers.GradientDescentSolver(grad, steps=15, lr=0.002).primal_solve(
        torch.from_numpy(v), torch.from_numpy(rho_d), torch.from_numpy(theta0))
    want = jsolvers.GradientDescentSolver(jgrad, steps=15, lr=0.002
                                          ).primal_solve(
        jnp.asarray(v), jnp.asarray(rho_d), jnp.asarray(theta0))
    assert_close(got, want)


def test_problem_from_numpy_rejects_unknown_task():
    x, y = linear_data()
    with pytest.raises(ValueError):
        interop.problem_from_numpy(x, y, "poisson", device="cpu")
