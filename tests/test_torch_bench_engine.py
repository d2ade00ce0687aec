"""The engine-smoke campaign's port (``repro_torch/bench/engine.py``) and
the two things it times against, on the CPU:

* ``core/seed_reference.py`` against the JAX package's frozen seed stepper
  at small size (8 workers, d=12): deterministic schemes to 1e-4
  max|theta*| at every iteration, with equal censor decisions; cq-ggadmm
  with the JAX draws injected as the same chain until its first
  stochastic-rounding flip (ROADMAP C2), with its bits within 5%. The
  port's engine equals the port's seed stepper bit for bit on one leaf at
  G=1, for every scheme (the seed's docstring contract).
* The multi-leaf per-leaf loop (``engine.grouped_quantize_step_unfused``)
  against the JAX one with the JAX per-leaf uniforms injected: ranges, bit
  widths, step sizes and payload equal; each reconstruction equal, or one
  step apart only where the stochastic rounding sits on a one-ulp
  boundary.
* Each engine stage at a reduced config has the JAX stage's section, data
  keys and claim names, but for the two documented differences
  (``pytree_fusion``'s launch count in place of its compile claim, and
  ``mix_sweep``'s ``mix_probe``); the deterministic numbers are equal. The
  JAX stages run with their timing, engine rollouts and quantize steps
  stubbed (they take seconds of compiling and decide no key).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import benchmarks.bench_engine as JB
from repro.core import admm_baselines as jab
from repro.core import engine as JE
from repro.core import seed_reference as jref
from repro.core.graph import random_bipartite_graph as jax_graph
from repro.core.quantization import QuantConfig as JQuantConfig
from repro.core.solvers import LinearRegressionProblem as JaxLinear
from repro_torch import interop
from repro_torch.bench import engine as BE
from repro_torch.core import admm_baselines as ab
from repro_torch.core import cq_ggadmm
from repro_torch.core import engine as E
from repro_torch.core import seed_reference as sr
from repro_torch.core.graph import random_bipartite_graph
from repro_torch.core.quantization import QuantConfig
from repro_torch.data import regression as R

N, D, ITERS = 8, 12, 50
DETERMINISTIC = ("ggadmm", "c-ggadmm", "c-admm", "jacobian-admm")
ALL_VARIANTS = DETERMINISTIC + ("q-ggadmm", "cq-ggadmm")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _Ctx:
    device = "cpu"
    store = None


@pytest.fixture(scope="module")
def linreg():
    x, y = R.partition_uniform(R.synth_linear(n=240, d=D, seed=0), N)
    prob = interop.problem_from_numpy(x, y, "linear", device="cpu")
    jprob = JaxLinear(jnp.asarray(x), jnp.asarray(y))
    return dict(graph=random_bipartite_graph(N, 0.4, seed=0),
                jgraph=jax_graph(N, 0.4, seed=0), prob=prob, jprob=jprob,
                star=np.asarray(jprob.optimum()))


def jax_seed_trajectory(s, cfg, iters, seed=0):
    """The JAX seed stepper stepped by hand (its ``run`` keeps no theta
    trajectory), with its draws: per iteration ``k1, k2 = split(key)`` and
    one ``uniform(k, (N, d))`` per phase."""
    step = jax.jit(jref.make_step(s["jgraph"], s["jprob"], cfg))
    state = jref.init_state(N, D, cfg)
    thetas, tx, pay = [], [], []
    for key in jax.random.split(jax.random.PRNGKey(seed), iters):
        state, m = step(state, key)
        thetas.append(np.asarray(m["theta"]))
        tx.append(np.asarray(m["tx_mask"]))
        pay.append(np.asarray(m["payload_bits"]))
    return np.stack(thetas), np.stack(tx), np.stack(pay)


def jax_draws(seed, iters):
    def one(key):
        k1, k2 = jax.random.split(key)
        return jnp.stack([jax.random.uniform(k1, (N, D), jnp.float32),
                          jax.random.uniform(k2, (N, D), jnp.float32)])
    keys = jax.random.split(jax.random.PRNGKey(seed), iters)
    return np.asarray(jax.jit(jax.vmap(one))(keys))


def port_seed_trajectory(s, cfg, iters, draws=None):
    step = sr.make_step(s["graph"], s["prob"], cfg, device="cpu")
    state = sr.init_state(N, D, cfg, device="cpu")
    gen = torch.Generator().manual_seed(0)
    thetas, tx, pay = [], [], []
    for it in range(iters):
        def draw(phase, it=it):
            if draws is not None:
                return torch.from_numpy(draws[it, phase].copy())
            return torch.rand((N, D), generator=gen)
        state, m = step(state, draw)
        thetas.append(m["theta"].numpy())
        tx.append(m["tx_mask"].numpy())
        pay.append(m["payload_bits"].numpy())
    return np.stack(thetas), np.stack(tx), np.stack(pay)


@pytest.mark.parametrize("scheme", DETERMINISTIC)
def test_seed_stepper_matches_the_jax_seed_stepper(linreg, scheme):
    jcfg = jab.ALL_SCHEMES[scheme](rho=1.0)
    want = jax_seed_trajectory(linreg, jcfg, ITERS)
    got = port_seed_trajectory(linreg, ab.ALL_SCHEMES[scheme](rho=1.0),
                               ITERS)
    tol = 1e-4 * np.abs(linreg["star"]).max()
    err = np.abs(got[0] - want[0]).max(axis=(1, 2))
    assert (err <= tol).all(), (err.max(), err.argmax())
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])


def test_cq_seed_stepper_matches_jax_with_its_draws_injected(linreg):
    want = jax_seed_trajectory(linreg, jab.cq_ggadmm(rho=1.0), ITERS)
    got = port_seed_trajectory(linreg, ab.cq_ggadmm(rho=1.0), ITERS,
                               draws=jax_draws(0, ITERS))
    star = np.asarray(linreg["star"])
    tol = 1e-4 * np.abs(star).max()
    err = np.abs(got[0] - want[0]).max(axis=(1, 2))
    # the same chain until a rounding decision lands within the solves'
    # rounding of its uniform (iteration 14 here; 14-17 over seeds 0-3);
    # after it, two samples of one chain: over seeds 0-3 their 50-iteration
    # bit totals part by -2.7% to +3.2%, and both reach the optimum alike
    parted = np.nonzero(err > tol)[0]
    first = int(parted[0]) if parted.size else ITERS
    assert first >= 10, first
    np.testing.assert_array_equal(got[1][:first], want[1][:first])
    np.testing.assert_array_equal(got[2][:first], want[2][:first])
    assert got[2].sum() == pytest.approx(want[2].sum(), rel=0.05)
    gap = [np.abs(x[0][-1] - star[None]).max() for x in (got, want)]
    assert gap[0] == pytest.approx(gap[1], rel=0.1)


@pytest.mark.parametrize("scheme", ALL_VARIANTS)
def test_engine_equals_the_seed_stepper_bit_for_bit(linreg, scheme):
    """The seed's contract: the engine with a one-leaf tree at G=1 and the
    same draws reproduces the frozen stepper bit for bit; the engine's
    ``payload_bits`` are the seed's times ``tx_mask`` (bits on the wire),
    its ``candidate_payload_bits`` the seed's."""
    s = linreg
    cfg = ab.ALL_SCHEMES[scheme](rho=1.0)
    star = s["prob"].optimum()
    kw = dict(dim=D, iters=ITERS, seed=3, theta_star=star,
              local_loss=s["prob"].local_loss, device="cpu")
    st_e, out_e = cq_ggadmm.run(s["graph"], s["prob"], cfg, **kw)
    st_s, out_s = sr.run(s["graph"], s["prob"], cfg, **kw)
    for key in ("tx_mask", "primal_residual", "objective", "dist_to_opt"):
        np.testing.assert_array_equal(out_e[key], out_s[key], err_msg=key)
    np.testing.assert_array_equal(out_e["payload_bits"],
                                  out_s["payload_bits"] * out_s["tx_mask"])
    np.testing.assert_array_equal(out_e["candidate_payload_bits"],
                                  out_s["payload_bits"])
    for name in ("theta", "theta_hat", "alpha"):
        assert torch.equal(getattr(st_e, name), getattr(st_s, name)), name
    assert torch.equal(st_e.quant.q_hat, st_s.quant.q_hat)
    assert torch.equal(st_e.quant.bits_prev[:, 0], st_s.quant.bits_prev)


def test_seed_stepper_takes_injected_draws_as_its_own(linreg):
    """``run(uniforms=...)`` with the generator's own draws is the seeded
    run."""
    s = linreg
    gen = torch.Generator().manual_seed(5)
    draws = [[torch.rand((N, D), generator=gen) for _ in range(2)]
             for _ in range(10)]
    cfg = ab.cq_ggadmm(rho=1.0)
    _, a = sr.run(s["graph"], s["prob"], cfg, D, 10, seed=5, device="cpu")
    _, b = sr.run(s["graph"], s["prob"], cfg, D, 10, device="cpu",
                  uniforms=lambda it, ph: draws[it][ph])
    for key in a:
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)


# --------------------------------------------------------- per-leaf loop --
LEAVES = {"a": (6, 5), "b": (6, 3, 4), "c": (6, 7), "d": (6, 1)}


def test_perleaf_loop_matches_jax_with_its_per_leaf_draws():
    rng = np.random.default_rng(0)
    gids = (0, 1, 0, 2)
    cfg = QuantConfig(b0=3, omega=0.9)
    jcfg = JQuantConfig(b0=3, omega=0.9)
    tree0 = {k: np.zeros(s, np.float32) for k, s in LEAVES.items()}
    state = E.GroupQuantState.create(
        {k: torch.from_numpy(v) for k, v in tree0.items()}, 3, b0=3)
    jstate = JE.GroupQuantState.create(
        {k: jnp.asarray(v) for k, v in tree0.items()}, 3, b0=3)
    key = jax.random.PRNGKey(7)
    for step in range(4):
        scale = 0.5 ** step
        tree = {k: (scale * rng.normal(size=s)).astype(np.float32)
                for k, s in LEAVES.items()}
        # leaf "d" of worker 2 does not move: a degenerate group there
        tree["d"][2] = np.asarray(state.q_hat["d"][2])
        k = jax.random.fold_in(key, step)
        keys = JE._leaf_keys(k, len(LEAVES))
        draws = [np.array(jax.random.uniform(kk, s, jnp.float32))
                 for kk, s in zip(keys, LEAVES.values())]
        jstate, jq, jbits, jpay = JE.grouped_quantize_step_unfused(
            jstate, {n: jnp.asarray(v) for n, v in tree.items()}, k, jcfg,
            gids)
        state, q, bits, pay = E.grouped_quantize_step_unfused(
            state, {n: torch.from_numpy(v) for n, v in tree.items()},
            [torch.from_numpy(u) for u in draws], cfg, gids)
        np.testing.assert_array_equal(bits.numpy(), np.asarray(jbits))
        np.testing.assert_array_equal(pay.numpy(), np.asarray(jpay))
        for f in ("range_prev", "bits_prev", "delta_prev", "initialized"):
            np.testing.assert_array_equal(getattr(state, f).numpy(),
                                          np.asarray(getattr(jstate, f)),
                                          err_msg=f)
        delta = np.asarray(jstate.delta_prev)
        for i, name in enumerate(LEAVES):
            got, want = q[name].numpy(), np.asarray(jq[name])
            step_g = delta[:, gids[i]].reshape((-1,) + (1,) *
                                               (got.ndim - 1))
            off = np.abs(got - want)
            # the plain kernel clips at 2R/Δ, the JAX loop at 2^b - 1:
            # equal, or one rounding apart
            assert (off <= 1e-6 * np.maximum(np.abs(want), 1.0)
                    + 1e-6 * step_g).all(), (step, name, off.max())
        # carry the JAX replica so the chains stay one chain
        state = dataclasses.replace(state, q_hat={
            n: torch.from_numpy(np.array(v)) for n, v in
            jstate.q_hat.items()})


def test_perleaf_loop_refuses_a_draw_count_other_than_its_leaves():
    tree = {k: torch.zeros(s) for k, s in LEAVES.items()}
    state = E.GroupQuantState.create(tree, 1)
    with pytest.raises(ValueError, match="3 uniform draws for 4 leaves"):
        E.grouped_quantize_step_unfused(state, tree, [torch.zeros(1)] * 3,
                                        QuantConfig(), (0, 0, 0, 0))


# ------------------------------------------------------------- stages --
REDUCED = {
    "stage_walltime": dict(n_workers=4, dim=4, iters=3),
    "stage_payload": dict(n=2, iters=3),
    "stage_pytree_fusion": dict(n_leaves=3, n=2, dim=4, iters=2),
    "stage_fused_range": dict(n_leaves=3, n=2, dim=4, iters=2),
    "stage_group_specs": dict(n_workers=4, iters=3),
    "stage_mix_sweep": dict(ns=(64,), ps=(0.1, 1.0), dim=8, inner=2),
}
# the documented differences: pytree_fusion counts launches where the JAX
# stage times a compile; mix_sweep records its dispatch-mode probe
EXTRA_KEYS = {"stage_pytree_fusion": {"fused_launches_per_step",
                                      "perleaf_launches_per_step",
                                      "fused_over_perleaf_launches"},
              "stage_mix_sweep": {"mix_probe"}}
CLAIM_SWAP = {"fused_quantize_faster_compile":
              "fused_quantize_fewer_launches"}


def _fake_run(graph, cfg, solver, theta0, iters, seed=0, **kw):
    """A stand-in for the JAX engine's rollout with the metrics' shapes:
    the group-spec stage's keys do not depend on the values."""
    n = jax.tree_util.tree_leaves(theta0)[0].shape[0]
    g = max(JE.resolve_groups(theta0, cfg.groups)) + 1
    z = jnp.zeros((iters, n), jnp.float32)
    return None, {"bits_per_group": jnp.zeros((iters, n, g)),
                  "group_tx": jnp.zeros((iters, n, g)), "tx_mask": z,
                  "payload_bits": z, "candidate_payload_bits": z}


def _fake_quantize(state, theta, key, cfg, group_ids, use_kernel=False):
    """A stand-in for the JAX quantize steps with their outputs' shapes
    (eager dispatch and jit compiles take seconds and decide no key)."""
    n = jax.tree_util.tree_leaves(theta)[0].shape[0]
    return state, theta, state.bits_prev, jnp.ones((n,), jnp.float32)


@pytest.fixture(scope="module")
def jax_records():
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(JB, "_time_run", lambda fn, repeats=5: 1.0)
        mp.setattr(JB.E, "run", _fake_run)
        for name in ("grouped_quantize_step", "grouped_quantize_step_twopass",
                     "grouped_quantize_step_unfused"):
            mp.setattr(JB.E, name, _fake_quantize)
        return {name: getattr(JB, name)(**kw) for name, kw in REDUCED.items()}
    finally:
        mp.undo()


@pytest.fixture(scope="module")
def port_records():
    return {name: getattr(BE, name)(ctx=_Ctx(), **kw)
            for name, kw in REDUCED.items()}


def _keys(data):
    return set(data) if isinstance(data, dict) else set()


@pytest.mark.parametrize("name", sorted(REDUCED))
def test_stage_has_the_jax_stages_section_keys_and_claims(
        name, jax_records, port_records):
    j, p = jax_records[name], port_records[name]
    assert p.section == j.section and p.claims_path == j.claims_path
    assert _keys(p.data) == _keys(j.data) | EXTRA_KEYS.get(name, set())
    for k, v in j.data.items():
        if isinstance(v, dict):
            assert _keys(p.data[k]) == _keys(v), k
            for kk, vv in v.items():
                assert _keys(p.data[k][kk]) == _keys(vv), (k, kk)
    assert [CLAIM_SWAP.get(c.name, c.name) for c in j.claims] == [
        c.name for c in p.claims]


def test_mix_backends_stage_has_the_jax_keys_and_agrees(monkeypatch):
    """The JAX sharded arm raises under jax 0.9.0 (ROADMAP C22), so the
    JAX stage's keys are read from its dense and sparse arms; the port
    adds the sharded arm at world size 1 over gloo, and every arm
    reproduces the dense trajectories."""
    from repro.core import topology as JT
    monkeypatch.setattr(JT, "BACKENDS", ("dense", "sparse"))
    monkeypatch.setattr(JB, "_time_run", lambda fn, repeats=5: (fn(), 1.0)[1])
    j = JB.stage_mix_backends(n_workers=4, dim=4, iters=3)
    monkeypatch.undo()
    had_group = torch.distributed.is_initialized()
    p = BE.stage_mix_backends(n_workers=4, dim=4, iters=3, ctx=_Ctx())
    assert p.section == j.section
    assert _keys(p.data) == _keys(j.data) | {"sharded"}
    for b in ("dense", "sparse", "sharded"):
        assert _keys(p.data[b]) == _keys(j.data["dense"]), b
        assert p.data[b]["tx_mask_identical"], b
    assert [c.name for c in p.claims] == [c.name for c in j.claims]
    assert p.claims[0].ok
    # a group the stage made is ended; a caller's stays
    assert torch.distributed.is_initialized() == had_group


def test_deterministic_numbers_equal_the_jax_stages(jax_records,
                                                    port_records):
    j, p = (r["stage_mix_sweep"].data for r in (jax_records, port_records))
    fields = ("n", "p", "edges", "dim", "dense_adjacency_bytes",
              "sparse_edge_bytes", "sparse_over_dense_bytes", "work_ratio")
    assert [{f: pt[f] for f in fields} for pt in p["points"]] == [
        {f: pt[f] for f in fields} for pt in j["points"]]
    for k in ("points_checked_at_low_p", "sparse_state_smaller_at_low_p",
              "sparse_less_work_at_low_p"):
        assert p[k] == j[k], k
    j, p = (r["stage_group_specs"].data
            for r in (jax_records, port_records))
    for mode in ("global", "group"):
        assert {k: v["n_groups"] for k, v in p[mode].items()} == {
            k: v["n_groups"] for k, v in j[mode].items()}
    j, p = (r["stage_pytree_fusion"].data
            for r in (jax_records, port_records))
    for k in ("n_leaves", "n_workers", "leaf_dim", "iters"):
        assert p[k] == j[k], k


def test_reduced_stages_hold_every_correctness_claim(port_records):
    """On the CPU the speed claims time plain PyTorch and are printed,
    not gated; every other claim holds (the payload stage's at its full
    config: three rounds are too few for per-layer groups to pay off)."""
    records = dict(port_records, stage_payload=BE.stage_payload(ctx=_Ctx()))
    for name, rec in records.items():
        for c in rec.claims:
            if c.name not in BE.SPEED_CLAIMS:
                assert c.ok, (name, c)
    fusion = port_records["stage_pytree_fusion"].data
    assert (fusion["fused_launches_per_step"],
            fusion["perleaf_launches_per_step"]) == (1, 3)
    probe = port_records["stage_mix_sweep"].data["mix_probe"]
    assert probe["sparse"]["matmul_ops"] == [] and probe["dense"][
        "matmul_ops"] == ["mm"]
    assert probe["dense"]["square_operand"]
    assert not probe["sparse"]["square_operand"]


# ------------------------------------------- the step's dispatch count --
def _one_iteration(step, state, uniforms, monkeypatch):
    """The aten ops one ``step(state, draw)`` dispatches (under
    ``bench/engine.py``'s recorder) and the tensors it builds from host
    data (calls of ``torch.tensor``, ``torch.as_tensor`` and
    ``torch.from_numpy``), after one warm-up step."""
    state, _ = step(state, lambda ph: uniforms[ph])
    made = []
    for name in ("tensor", "as_tensor", "from_numpy"):
        real = getattr(torch, name)

        def counting(*a, _real=real, _name=name, **kw):
            made.append(_name)
            return _real(*a, **kw)
        monkeypatch.setattr(torch, name, counting)
    with BE._OpRecorder() as rec:
        step(state, lambda ph: uniforms[ph])
    monkeypatch.undo()
    return [name for name, _ in rec.seen], made


def test_engine_step_dispatches_at_most_105_percent_of_the_seed_ops(
        monkeypatch):
    """At the walltime stage's shape (cq-ggadmm, 16 workers, d 64) one
    engine iteration dispatches at most 1.05x the aten ops of one seed
    stepper iteration, and builds no tensor from host data: its constants
    (the censor decay, the schedule's ln 2, the phase masks) are on the
    device before the loop. Both loops are host-bound on the card, so the
    dispatch count sets their time (``engine_walltime_comparable``)."""
    graph, prob = BE._problem(16, 64, 0.4, torch.device("cpu"))
    cfg = ab.ALL_SCHEMES["cq-ggadmm"](rho=1.0)
    gen = torch.Generator().manual_seed(0)
    uniforms = [torch.rand((16, 64), generator=gen) for _ in range(2)]
    solver = E.ExactSolver(prob)
    engine_ops, engine_made = _one_iteration(
        E.make_step(graph, cfg, solver, device="cpu"),
        E.init_state(torch.zeros((16, 64)), cfg, solver), uniforms,
        monkeypatch)
    seed_ops, _ = _one_iteration(
        sr.make_step(graph, prob, cfg, device="cpu"),
        sr.init_state(16, 64, cfg, "cpu"), uniforms, monkeypatch)
    assert len(engine_ops) <= 1.05 * len(seed_ops), (len(engine_ops),
                                                     len(seed_ops))
    assert engine_made == [] and "lift_fresh" not in engine_ops, (
        engine_made, engine_ops.count("lift_fresh"))
    # the seed stepper copies its censor decay and ln 2 every phase
    assert seed_ops.count("lift_fresh") == 4
