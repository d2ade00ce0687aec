"""The exact linear solve factored once a graph (``core/engine.py``,
``core/solvers.py``): each phase of a step function factors its workers'
systems ``X_n^T X_n + quad_n I`` on its first solve and applies the factor
to its rows from then on.

* The factored run equals the solve-all-then-select run (the same problem
  behind an object with ``primal_solve`` only) bit for bit, every state
  tensor and every metric, over 12 iterations holding one redraw, for
  GGADMM, C-GGADMM, CQ-GGADMM (draws injected) and the censored Jacobian
  C-ADMM, on the dense, sparse and sharded (world 1) backends. On the CPU
  ``lu_factor`` then ``lu_solve`` is the factor and the solve that
  ``torch.linalg.solve`` makes, row by row.
* Traced (an in-memory tracer), ``engine.solve`` holds one
  ``solve.factor`` a phase per step function, a new one after a redraw,
  and a ``solve.apply`` every solve.
* A logistic problem (Newton), a problem with ``primal_solve`` only, the
  gradient-descent solver and the inexact solver take the old path: no
  ``solve.factor`` or ``solve.apply`` span.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import interop
from repro_torch.core import admm_baselines as ab
from repro_torch.core import dynamic
from repro_torch.core import engine as E
from repro_torch.core import solvers
from repro_torch.core.graph import random_bipartite_graph
from repro_torch.data import regression as R
from repro_torch.obs import trace as obs_trace

N, D, ITERS, REFRESH = 12, 20, 12, 6
SCHEMES = ("ggadmm", "c-ggadmm", "cq-ggadmm", "c-admm")
BACKENDS = ("dense", "sparse", "sharded")


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class SolveOnly:
    """A linear problem seen through ``primal_solve`` alone: the engine
    solves every row and selects, as before factoring."""

    def __init__(self, problem):
        self.problem = problem

    def primal_solve(self, v, rho_d, theta_init=None):
        return self.problem.primal_solve(v, rho_d, theta_init)


def linear_problem(seed=0):
    x, y = R.partition_uniform(R.synth_linear(n=N * 30, d=D, seed=seed), N)
    return interop.problem_from_numpy(x, y, "linear", device="cpu")


def draws(seed=5):
    gen = torch.Generator().manual_seed(seed)
    table = [[torch.rand((N, D), generator=gen) for _ in range(2)]
             for _ in range(ITERS)]
    return lambda it, phase: table[it][phase]


def scheme_cfg(scheme, backend):
    return dataclasses.replace(ab.ALL_SCHEMES[scheme](rho=1.0),
                               mix_backend=backend)


def run(problem, cfg, uniforms=None):
    prob = problem.problem if isinstance(problem, SolveOnly) else problem
    topo = dynamic.DynamicTopology(N, 0.4, refresh_every=REFRESH, seed=3)
    return dynamic.run_dynamic(topo, problem, cfg, D, ITERS, seed=7,
                               local_loss=prob.local_loss,
                               uniforms=uniforms, device="cpu")


def traced(fn):
    """``fn()``'s result and the closed spans of an in-memory tracer
    enabled around it."""
    tr = obs_trace.enable(None)
    try:
        out = fn()
    finally:
        obs_trace.disable(save=False)
    return out, obs_trace.closed_spans(tr.events())


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("scheme", SCHEMES)
def test_the_factored_run_equals_the_solve_all_run_bit_for_bit(scheme,
                                                               backend):
    cfg = scheme_cfg(scheme, backend)
    prob = linear_problem()
    assert E.ExactSolver(prob).factors
    assert not E.ExactSolver(SolveOnly(prob)).factors
    u = draws() if cfg.quantize is not None else None
    st_f, out_f = run(prob, cfg, u)
    st_a, out_a = run(SolveOnly(prob), cfg, u)
    assert out_f.keys() == out_a.keys()
    for key in out_f:
        np.testing.assert_array_equal(out_f[key], out_a[key], err_msg=key)
    for name in ("theta", "theta_hat", "alpha"):
        assert torch.equal(getattr(st_f, name), getattr(st_a, name)), name
    for f in dataclasses.fields(E.GroupQuantState):
        assert torch.equal(getattr(st_f.quant, f.name),
                           getattr(st_a.quant, f.name)), f.name
    # the run moved: a solve that did nothing would also agree
    assert float(out_f["primal_residual"][-1]) < float(
        out_f["primal_residual"][0])


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("scheme", ("cq-ggadmm", "c-admm"))
def test_one_factor_a_phase_per_step_function_and_anew_after_a_redraw(
        scheme, backend):
    cfg = scheme_cfg(scheme, backend)
    u = draws() if cfg.quantize is not None else None
    _, spans = traced(lambda: run(linear_problem(), cfg, u))
    phases = 2 if cfg.alternating else 1
    graphs = ITERS // REFRESH
    order = [s[0] for s in spans
             if s[0] in ("engine.make_step", "solve.factor")]
    assert order == (["engine.make_step"] + ["solve.factor"] * phases) \
        * graphs
    by_name = {}
    for name, _, _, b, e, args in spans:
        by_name.setdefault(name, []).append((b, e, args))
    assert len(by_name["solve.apply"]) == phases * ITERS
    assert len(by_name["engine.solve"]) == phases * ITERS
    # each graph's factors cover its workers once: the head and tail rows
    rows = [a["rows"] for _, _, a in by_name["solve.factor"]]
    assert [sum(rows[i:i + phases]) for i in range(0, len(rows), phases)] \
        == [N] * graphs
    for name in ("solve.factor", "solve.apply"):
        for b, e, _ in by_name[name]:
            assert any(sb <= b and e <= se
                       for sb, se, _ in by_name["engine.solve"]), name


def logistic_solver():
    x, y = R.partition_uniform(R.synth_logistic(n=N * 30, d=D, seed=1), N)
    return E.ExactSolver(interop.problem_from_numpy(x, y, "logistic",
                                                    device="cpu"))


def gradient_descent_solver():
    prob = linear_problem()

    def local_grad(theta):
        return (torch.einsum("nde,ne->nd", prob.gram, theta) - prob.xty)
    return E.ExactSolver(solvers.GradientDescentSolver(local_grad, steps=5,
                                                       lr=1e-3))


def inexact_solver():
    # f_n = 0.5 ||theta - 1||^2: the acting rows' gradient
    return E.InexactSolver(grad_fn=lambda theta, batch: theta - 1.0,
                           local_steps=2, local_lr=1e-2)


OLD_PATH = {"logistic": logistic_solver,
            "primal-solve-only": lambda: E.ExactSolver(
                SolveOnly(linear_problem())),
            "gradient-descent": gradient_descent_solver,
            "inexact": inexact_solver}


@pytest.mark.parametrize("kind", sorted(OLD_PATH))
def test_solvers_that_do_not_factor_keep_the_old_path(kind):
    solver = OLD_PATH[kind]()
    assert not getattr(solver, "factors", False)
    cfg = ab.cq_ggadmm(rho=1.0)
    graph = random_bipartite_graph(N, 0.4, seed=2)
    theta0 = torch.zeros((N, D))

    def go():
        return E.run(graph, cfg, solver, theta0, 3, seed=1)
    (state, _), spans = traced(go)
    names = [s[0] for s in spans]
    assert names.count("engine.solve") == 6
    assert "solve.factor" not in names and "solve.apply" not in names
    assert torch.isfinite(state.theta).all() and state.theta.abs().sum() > 0
