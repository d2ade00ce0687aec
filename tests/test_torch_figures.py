"""The paper's figures and Theorem 3 through the port (``bench/figures.py``,
``core/theory.py``) against ``benchmarks/bench_figures.py``,
``benchmarks/common.py`` and ``repro.core.theory`` on the CPU.

Tolerances and their reasons:

* the theory copy: every constant, bound and rate within 1e-6 relative
  (the same numpy code on the same graphs; SVDs of one LAPACK);
* ``make_problem``: graphs and data equal (numpy copies of the surrogates);
* the deterministic schemes (c-admm, ggadmm, c-ggadmm) at Figs. 2 and 4's
  settings, 80 iterations (ROADMAP C3: past ~88 the censor boundary sits
  below the runs' float32 agreement): cumulative rounds and bits equal, the
  objective error within 1e-4 of the optimum's objective (float32 solves in
  two LAPACKs);
* the quantized schemes (cq-ggadmm, q-ggadmm) with the JAX draws injected:
  a stochastic rounding flips where ``frac(c)`` sits within the solves'
  rounding of the draw, and from there the runs are different samples of
  one chain (ROADMAP C2). Iteration 0 agrees (payload bits equal, the
  objective error within 1e-4 of the optimum's objective); the paper's
  scheme, cq-ggadmm, keeps its cumulative bits after 120 iterations
  within C2's 3%. q-ggadmm (the informational column) parts at iteration
  1 on Fig. 4 and is 9.4% off in bits after 120 iterations on Fig. 2, so
  past iteration 0 it is held to nothing but reaching its bits;
* Fig. 3 end to end with the JAX draws injected: the deterministic rows
  within one iteration of the JAX rows (c-admm crosses the 1e-4 target at
  333 against 334: its objective error sits there within float32 rounding
  of the target), their rounds and bits within two iterations' worth, and
  the claims that read only them equal. The quantized runs part from the
  JAX package's at the first flip (iteration 16 for cq-ggadmm) and reach
  the target at other iterations, so ``cq_fewest_bits`` and
  ``cq_least_energy``, which JAX holds by 5.7% of the bits on its seed,
  are compared only through both rows reaching the target (ROADMAP C16
  has the eight-seed study).
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks import bench_figures as jfig
from benchmarks import common as jcommon
from repro.core import admm_baselines as jab
from repro.core import cq_ggadmm as jcq
from repro.core import theory as jtheory
from repro.core.graph import random_bipartite_graph as jgraph
from repro.core.solvers import LinearRegressionProblem as JLinear
from repro.data import regression as JR
from repro_torch.bench import figures
from repro_torch.core import admm_baselines as ab
from repro_torch.core import cq_ggadmm as cq
from repro_torch.core import theory
from repro_torch.core.graph import random_bipartite_graph
from repro_torch.core.solvers import LinearRegressionProblem
from repro_torch.data import regression as R

DETERMINISTIC = ("c-admm", "ggadmm", "c-ggadmm")
QUANTIZED = ("cq-ggadmm", "q-ggadmm")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_draws(seed, iters, n, d):
    """The JAX engine's draws for a one-leaf tree (``engine.run``): keys
    split from PRNGKey(seed), one per iteration, split per phase."""
    def one(key):
        k1, k2 = jax.random.split(key)
        return jnp.stack([jax.random.uniform(k1, (n, d), jnp.float32),
                          jax.random.uniform(k2, (n, d), jnp.float32)])
    keys = jax.random.split(jax.random.PRNGKey(seed), iters)
    u = np.asarray(jax.jit(jax.vmap(one))(keys))
    return lambda it, ph: torch.from_numpy(u[it, ph].copy())


# ------------------------------------------------------------- theory --
GRAPHS = [(12, 0.4, 5), (18, 0.2, 2), (24, 0.35, 0)]


@pytest.mark.parametrize("n,p,seed", GRAPHS)
def test_theory_copy_equals_the_original(n, p, seed):
    g, jg = random_bipartite_graph(n, p, seed=seed), jgraph(n, p, seed=seed)
    got, want = theory.topology_constants(g), jtheory.topology_constants(jg)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6)
    mu, lips = 0.7, 40.0
    for kw in (dict(rho=1e-3, kappa=1e-4), dict(rho=1e-4, kappa=1e-3,
                                                  psi=0.99, eta=4.0)):
        a = theory.rate_bound(g, mu, lips, **kw)
        b = jtheory.rate_bound(jg, mu, lips, **kw)
        assert a.feasible == b.feasible
        for f in ("rho_bar", "rate", "kappa", "delta"):
            np.testing.assert_allclose(getattr(a, f), getattr(b, f),
                                       rtol=1e-6)
    for psi in (0.0, 0.995):
        a = theory.best_rate_bound(g, mu, lips, rho=1e-4, psi=psi)
        b = jtheory.best_rate_bound(jg, mu, lips, rho=1e-4, psi=psi)
        assert (a is None) == (b is None)
        if a is not None:
            for f in ("rho_bar", "rate", "kappa", "delta"):
                np.testing.assert_allclose(getattr(a, f), getattr(b, f),
                                           rtol=1e-6)
    x = np.random.default_rng(seed).standard_normal((n, 30, 6))
    np.testing.assert_allclose(theory.linreg_convexity(x),
                               jtheory.linreg_convexity(x), rtol=1e-6)


@pytest.fixture(scope="module")
def setup():
    """``tests/test_theory.py``'s setup through the port."""
    data = R.synth_linear(n=720, d=12, seed=5)
    g = random_bipartite_graph(12, 0.4, seed=5)
    x, y = R.partition_uniform(data, 12)
    prob = LinearRegressionProblem(torch.from_numpy(x.astype(np.float32)),
                                   torch.from_numpy(y.astype(np.float32)))
    mu, lips = theory.linreg_convexity(np.asarray(x))
    return g, prob, mu, lips


def test_topology_constants_sane(setup):
    g, *_ = setup
    tc = theory.topology_constants(g)
    assert tc["sigma_max_C"] > 0
    assert 0 < tc["sigma_min_M"] <= tc["sigma_max_M"]
    assert tc["sigma_max_M"] ** 2 <= 2 * g.degrees.max() + 1e-5


def test_certificate_exists_for_small_rho(setup):
    g, prob, mu, lips = setup
    cert = theory.best_rate_bound(g, mu, lips, rho=1e-4)
    assert cert is not None and cert.feasible
    assert 0.5 <= cert.rate < 1.0
    assert cert.rho_bar > 1e-4


def measured_contraction(g, prob, rho, iters=120):
    """Mean per-iteration contraction of ||theta - theta*||^2 over
    iterations 10..79 of a ggadmm run (``tests/test_theory.py``'s)."""
    _, out = cq.run(g, prob, ab.ggadmm(rho=rho), dim=prob.dim, iters=iters,
                    theta_star=prob.optimum(), device=prob.x.device)
    d = np.maximum(out["dist_to_opt"], 1e-30)
    window = d[10:80]
    return (window[-1] / window[0]) ** (1.0 / (len(window) - 1))


def test_measured_contraction_respects_certificate(setup):
    g, prob, mu, lips = setup
    rho = 1e-3
    cert = theory.best_rate_bound(g, mu, lips, rho=rho)
    assert cert is not None
    measured = measured_contraction(g, prob, rho)
    assert measured <= cert.rate + 1e-6, (measured, cert.rate)
    # the JAX package's run measures the same contraction
    data = JR.synth_linear(n=720, d=12, seed=5)
    x, y = JR.partition_uniform(data, 12)
    jprob = JLinear(jnp.asarray(x), jnp.asarray(y))
    _, jout = jcq.run(jgraph(12, 0.4, seed=5), jprob, jab.ggadmm(rho=rho),
                      dim=12, iters=120, theta_star=jprob.optimum())
    jd = np.maximum(jout["dist_to_opt"], 1e-30)[10:80]
    np.testing.assert_allclose(measured, (jd[-1] / jd[0]) ** (1 / 69),
                               rtol=1e-4)


def test_denser_graph_certifies_no_worse(setup):
    sparse = random_bipartite_graph(12, 0.2, seed=7)
    dense = random_bipartite_graph(12, 0.5, seed=7)
    assert (theory.topology_constants(dense)["sigma_min_M"]
            >= theory.topology_constants(sparse)["sigma_min_M"] - 1e-9)


def test_cq_psi_loosens_rate(setup):
    g, prob, mu, lips = setup
    exact = theory.best_rate_bound(g, mu, lips, rho=1e-4, psi=0.0)
    quant = theory.best_rate_bound(g, mu, lips, rho=1e-4, psi=0.995)
    assert exact is not None and quant is not None
    assert quant.rate >= exact.rate
    assert quant.rate < 1.0


# ------------------------------------------------------------ harness --
@pytest.mark.parametrize("dataset,n,seed,p", [
    ("synth-linear", 24, 0, 0.35), ("bodyfat", 18, 2, 0.2),
    ("synth-logistic", 24, 0, 0.35), ("derm", 18, 0, 0.35)])
def test_make_problem_equals_the_harness(dataset, n, seed, p):
    g, prob = figures.make_problem(dataset, n, seed, p, device="cpu")
    jg, jprob = jcommon.make_problem(dataset, n, seed, p)
    np.testing.assert_array_equal(g.adjacency, jg.adjacency)
    np.testing.assert_array_equal(g.head_mask, jg.head_mask)
    np.testing.assert_array_equal(prob.x.numpy(), np.asarray(jprob.x))
    np.testing.assert_array_equal(prob.y.numpy(), np.asarray(jprob.y))
    assert type(prob).__name__ == type(jprob).__name__
    if dataset in ("synth-logistic", "derm"):
        assert (prob.mu0, prob.newton_steps) == (jprob.mu0,
                                                 jprob.newton_steps)


FIGS = {  # figure -> (dataset, workers, rho, per-scheme overrides)
    "fig2": ("synth-linear", 24, 1.0, {}),
    "fig4": ("synth-logistic", 24, 0.2, {"c-admm": dict(rho=0.1)}),
}


def _pair(fig, name, iters, uniforms=None):
    dataset, n, rho, over = FIGS[fig]
    kw = dict(over.get(name, {}))
    rho = kw.pop("rho", rho)
    g, prob = figures.make_problem(dataset, n, device="cpu")
    jg, jprob = jcommon.make_problem(dataset, n)
    got = figures.run_scheme(name, g, prob, rho=rho, iters=iters,
                             uniforms=uniforms, **kw)
    want = jcommon.run_scheme(name, jg, jprob, rho=rho, iters=iters, **kw)
    return got, want, float(jprob.global_loss(jprob.optimum()))


@pytest.mark.parametrize("name", DETERMINISTIC)
@pytest.mark.parametrize("fig", sorted(FIGS))
def test_deterministic_schemes_match_the_harness(fig, name):
    got, want, f_star = _pair(fig, name, 80)
    np.testing.assert_array_equal(got.rounds, want.rounds)
    np.testing.assert_array_equal(got.bits, want.bits)
    np.testing.assert_allclose(got.energy, want.energy, rtol=1e-6)
    np.testing.assert_allclose(got.gap, want.gap, rtol=0,
                               atol=1e-4 * abs(f_star))


@pytest.mark.parametrize("name", QUANTIZED)
@pytest.mark.parametrize("fig", sorted(FIGS))
def test_quantized_schemes_match_the_harness_with_jax_draws(fig, name):
    dataset, n, *_ = FIGS[fig]
    d = R.DATASETS[dataset]().dim
    got, want, f_star = _pair(fig, name, 120,
                              uniforms=jax_draws(0, 120, n, d))
    assert got.bits[0] == want.bits[0] and got.rounds[0] == want.rounds[0]
    assert abs(got.gap[0] - want.gap[0]) <= 1e-4 * abs(f_star)
    if name == "cq-ggadmm":
        assert abs(got.bits[-1] / want.bits[-1] - 1.0) <= 0.03, (
            got.bits[-1], want.bits[-1])


def test_fig3_end_to_end_with_jax_draws(monkeypatch):
    want_rows, want_claims = jfig.fig3_linreg_real()
    draws = jax_draws(0, 400, 18, 14)
    orig = figures.run_scheme
    monkeypatch.setattr(figures, "run_scheme",
                        lambda *a, **kw: orig(*a, uniforms=draws, **kw))
    rows, claims = figures.fig3_linreg_real(device="cpu")
    assert sorted(rows) == sorted(want_rows)
    assert sorted(claims) == sorted(want_claims)
    for name in DETERMINISTIC:
        got, want = rows[name], want_rows[name]
        assert abs(got["iters"] - want["iters"]) <= 1, name
        for col in ("rounds", "bits", "energy"):
            per_iter = want[col] / want["iters"]
            assert abs(got[col] - want[col]) <= 2 * per_iter, (name, col)
    for name in QUANTIZED:
        assert np.isfinite(rows[name]["iters"])
        assert np.isfinite(want_rows[name]["iters"])
    for claim in ("ggadmm_fewer_iters_than_cadmm", "all_reach_target",
                  "censoring_saves_rounds"):
        assert claims[claim] == want_claims[claim], claim


def test_main_writes_json_and_fails_on_a_false_claim(tmp_path, monkeypatch):
    """``main`` writes every row and claim and returns 0 when all hold, 1
    when one is forced false (the JAX campaign's exit code). The runner's
    state goes to the default ``campaigns/torch`` of the working
    directory."""
    monkeypatch.chdir(tmp_path)
    rows = {"a": {"iters": 3, "rounds": 4.0, "bits": np.inf,
                  "energy": 1.0, "final_gap": 0.0}}
    monkeypatch.setitem(figures.ALL_FIGURES, "fig_true",
                        lambda device=None: (rows, {"holds": True}))
    monkeypatch.setitem(figures.ALL_FIGURES, "fig_false",
                        lambda device=None: (rows, {"holds": False}))
    out = tmp_path / "f.json"
    assert figures.main(["--figures", "fig_true", "--out", str(out),
                         "--device", "cpu"]) == 0
    doc = json.loads(out.read_text())
    assert doc["fig_true"]["claims"] == {"holds": True}
    assert doc["fig_true"]["rows"]["a"]["bits"] == "inf"
    assert figures.main(["--figures", "fig_true,fig_false", "--out",
                         str(out), "--device", "cpu"]) == 1
    assert json.loads(out.read_text())["fig_false"]["claims"] == {
        "holds": False}
