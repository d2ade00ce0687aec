"""Narrowed replicas (``hat_dtype``) in the port against the JAX package, at
smoke size, on the same numpy-seeded inputs.

``theta_hat``, ``alpha`` and ``q_hat`` are stored in bf16 (or f16); every
quantity computed from them is float32, rounded once where it is stored.

Tolerances and their reasons:

* The plain narrowed kernels are the float32 route rounded once. B2 on
  bf16 or f16 values equals the Pallas ``bipartite_mix`` in interpret mode
  bit for bit while N fits one 128-row k block (the kernel's float32 dot
  is rounded once there), and XLA's jitted bf16 dot to one bf16 step. B6 on
  narrowed values equals the Pallas ``edge_gather_mix`` bit for bit (both
  widen first and sum in float32 in slot order).
* The packed quantize with a bf16 ``q_hat`` and the JAX package's
  ``_grouped_quantize_step_packed`` (its plain route): the (N, G) outputs
  bit for bit and the bf16 reconstruction bit for bit, both being the
  float32 round rounded once.
* Trajectories. A replica is ``theta`` rounded to bf16, and the two
  packages' float32 solves differ by ~1e-7 relative; once a coordinate
  sits that close to a bf16 rounding boundary the two runs store
  neighbouring bf16 values and go on as two paths on the bf16 lattice
  (on quickstart part 1, first at iteration 9). Held: before the first
  replica that differs, theta within 1e-4 max|theta*| (the float32
  tolerance of ``test_torch_engine.py``); at every iteration within 16
  bf16 steps of max|theta*| (16 * 2^-8; about 11 are seen over 300
  iterations); the transmit masks equal (a ``tx_mask`` flip allowed only
  at the censor boundary); each run's final distance to the optimum below
  1e-3 of its start (the bf16 floor).
* The JAX package's default dense route, ``adjacency.astype(bf16) @
  flat`` under ``jax.jit``, keeps the product unrounded on the CPU (XLA's
  excess precision drops the bf16 round trip into the float32 solve), so
  it parts from every route that stores the mix in bf16 at iteration 0
  (109 of 1,200 replica values on quickstart part 1). The parity runs take
  the JAX routes that store it, ``use_pallas_mix=True``; the sparse JAX
  default sums in bf16 (``segment_sum``) and is not held either.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.core import admm_baselines as jab
from repro.core import consensus as JC
from repro.core import engine as JE
from repro.core.censoring import CensorConfig as JCensor
from repro.core.graph import random_bipartite_graph as jax_graph
from repro.core.quantization import QuantConfig as JQuant
from repro.core.solvers import LinearRegressionProblem as JaxLinear
from repro.data import lm as jlm
from repro.fleet import faults as jfaults
from repro.fleet import sim as jsim
from repro.kernels import bipartite_mix as jmix
from repro.kernels import edge_gather_mix as jedge
from repro.models import registry as jregistry
from repro.runtime import steps as JST
from repro_torch import interop
from repro_torch.configs import base
from repro_torch.core import admm_baselines as ab
from repro_torch.core import consensus as C
from repro_torch.core import engine as E
from repro_torch.core import packing
from repro_torch.core import tree as T
from repro_torch.core.censoring import CensorConfig
from repro_torch.core.graph import random_bipartite_graph
from repro_torch.core.quantization import QuantConfig
from repro_torch.data import regression as R
from repro_torch.fleet import faults
from repro_torch.fleet import sim
from repro_torch.kernels import ops, ref
from repro_torch.launch import train

N, D = 24, 50
BF16_STEP = 2.0 ** -8          # bf16's relative spacing
NARROW = {"bfloat16": (torch.bfloat16, jnp.bfloat16),
          "float16": (torch.float16, jnp.float16)}


@pytest.fixture(scope="module")
def quick():
    """Quickstart part 1: 24 workers, synth-linear d=50, p=0.35, seed 0."""
    x, y = R.partition_uniform(R.synth_linear(), N)
    jprob = JaxLinear(jnp.asarray(x), jnp.asarray(y))
    return dict(graph=random_bipartite_graph(N, 0.35, seed=0),
                jgraph=jax_graph(N, 0.35, seed=0),
                prob=interop.problem_from_numpy(x, y, "linear", device="cpu"),
                jprob=jprob, jstar=np.asarray(jprob.optimum()))


def to_jax(t: torch.Tensor):
    """A narrowed or float32 tensor as the same JAX array, bit for bit."""
    if t.dtype == torch.bfloat16:
        return jnp.asarray(t.view(torch.int16).numpy()).view(jnp.bfloat16)
    return jnp.asarray(t.numpy())


def to_torch(a) -> torch.Tensor:
    a = jnp.asarray(a)
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(np.asarray(a.view(jnp.int16))).view(
            torch.bfloat16)
    return torch.from_numpy(np.array(a))


# ------------------------------------------------------------ the state --
def one_leaf(n=4):
    return torch.zeros((n, 7)), jnp.zeros((n, 7), jnp.float32)


def two_leaves(n=4):
    return ({"w": torch.zeros((n, 3, 2)), "b": torch.zeros((n, 5))},
            {"w": jnp.zeros((n, 3, 2), jnp.float32),
             "b": jnp.zeros((n, 5), jnp.float32)})


@pytest.mark.parametrize("tree", [one_leaf, two_leaves])
@pytest.mark.parametrize("hat", ["bfloat16", "float16", "float32"])
def test_init_state_narrows_the_replicas_as_jax(tree, hat):
    theta, jtheta = tree()
    kw = dict(quantize=QuantConfig(b0=4), groups="leaf")
    st = E.init_state(theta, E.EngineConfig(hat_dtype=hat, **kw))
    jst = JE.init_state(jtheta, JE.EngineConfig(
        hat_dtype=hat, quantize=JQuant(b0=4), groups="leaf"))
    for name in ("theta_hat", "alpha"):
        got = [str(x.dtype).replace("torch.", "")
               for x in T.leaves(getattr(st, name))]
        want = [str(x.dtype) for x in jax.tree_util.tree_leaves(
            getattr(jst, name))]
        assert got == want == [hat] * len(got), name
    got = [str(x.dtype).replace("torch.", "") for x in T.leaves(st.quant.q_hat)]
    assert got == [hat] * len(got)
    assert all(x.dtype == torch.float32 for x in T.leaves(st.theta))
    assert st.quant.range_prev.dtype == torch.float32
    np.testing.assert_array_equal(st.quant.bits_prev.numpy(),
                                  np.asarray(jst.quant.bits_prev))


def test_hat_dtype_names_are_checked_and_sharded_still_refused():
    with pytest.raises(ValueError, match="hat_dtype"):
        E.EngineConfig(hat_dtype="int8")
    with pytest.raises(NotImplementedError):
        E.EngineConfig(hat_dtype="bfloat16", mix_backend="sharded")
    assert C.ConsensusConfig(hat_dtype="bfloat16").engine_config(
    ).hat_dtype == "bfloat16"


def test_identity_step_respects_replica_dtype():
    """The stored replica narrows to the state's ``q_hat`` dtype while the
    candidate keeps full precision (JAX ``tests/test_quantization.py``)."""
    n, d = 3, 8
    st = E.GroupQuantState.create(torch.zeros((n, d)), 1,
                                  hat_dtype=torch.bfloat16)
    theta = torch.from_numpy(
        np.random.default_rng(0).standard_normal((n, d)).astype(np.float32))
    new, candidate, bits, payload = E.identity_quantize_step(st, theta)
    assert new.q_hat.dtype == torch.bfloat16
    assert candidate.dtype == torch.float32
    torch.testing.assert_close(new.q_hat, theta.bfloat16(), rtol=0, atol=0)
    torch.testing.assert_close(candidate, theta, rtol=0, atol=0)
    assert (payload == 32.0 * d).all()


def test_interop_carries_narrowed_state_both_ways():
    """A JAX engine state with bf16 replicas crosses as numpy (``np.asarray``
    of a JAX bf16 array is an ml_dtypes array) and back, bit for bit."""
    _, jtheta = two_leaves()
    jtheta = jax.tree_util.tree_map(
        lambda x: jax.random.normal(jax.random.PRNGKey(3), x.shape), jtheta)
    jst = JE.init_state(jtheta, JE.EngineConfig(hat_dtype="bfloat16"))
    jst = dataclasses.replace(jst, theta_hat=jax.tree_util.tree_map(
        lambda x: x.astype(jnp.bfloat16) * 3, jtheta))
    flat = {}
    for name in ("theta", "theta_hat", "alpha"):
        for p, x in jax.tree_util.tree_flatten_with_path(
                getattr(jst, name))[0]:
            flat[name + jax.tree_util.keystr(p)] = np.asarray(x)
    for p, x in jax.tree_util.tree_flatten_with_path(jst.quant.q_hat)[0]:
        flat["quant.q_hat" + jax.tree_util.keystr(p)] = np.asarray(x)
    for f in interop.SIDE_FIELDS:
        flat[f"quant.{f}"] = np.asarray(getattr(jst.quant, f))
    flat["k"] = np.asarray(jst.k)
    st = interop.engine_state_from_numpy(flat, device="cpu")
    assert st.theta_hat["w"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        st.theta_hat["w"].float().numpy(),
        np.asarray(jst.theta_hat["w"].astype(jnp.float32)))
    back = interop.engine_state_to_numpy(st)
    for k, v in flat.items():
        assert back[k].dtype == v.dtype, k
        np.testing.assert_array_equal(back[k], v, err_msg=k)


# ------------------------------------------------------ the plain kernels --
MIX_SHAPES = [(24, 24, 50), (64, 64, 2000), (12, 24, 513), (128, 128, 300)]


def mix_inputs(m, n, d, dtype, seed):
    rng = np.random.default_rng(seed)
    adj = (rng.uniform(size=(m, n)) < 0.35).astype(np.float32)
    vals = torch.from_numpy(
        (3.0 * rng.standard_normal((n, d))).astype(np.float32)).to(dtype)
    return torch.from_numpy(adj), vals


@pytest.mark.parametrize("hat", sorted(NARROW))
@pytest.mark.parametrize("shape", MIX_SHAPES, ids=str)
def test_plain_narrowed_mix_is_the_pallas_kernel_and_xla_dot(shape, hat):
    tdt, jdt = NARROW[hat]
    adj, vals = mix_inputs(*shape, tdt, seed=sum(shape))
    got = ops.bipartite_mix(adj, vals)
    assert got.dtype == tdt
    want32 = (adj @ vals.float()).to(tdt)
    torch.testing.assert_close(got, want32, rtol=0, atol=0)
    pallas = jmix.bipartite_mix(jnp.asarray(adj.numpy()), to_jax(vals),
                                interpret=True)
    assert pallas.dtype == jdt
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(pallas.astype(jnp.float32)))
    dot = np.asarray(jax.jit(lambda a, v: a.astype(v.dtype) @ v)(
        jnp.asarray(adj.numpy()), to_jax(vals)).astype(jnp.float32))
    step = np.abs(got.float().numpy()) * (BF16_STEP if hat == "bfloat16"
                                          else 2.0 ** -11)
    assert (np.abs(got.float().numpy() - dot) <= step + 1e-30).all()


@pytest.mark.parametrize("hat", sorted(NARROW))
def test_plain_edge_gather_reads_narrowed_values_as_the_pallas_kernel(hat):
    tdt, _ = NARROW[hat]
    g = random_bipartite_graph(24, 0.35, seed=1)
    table, valid = g.neighbor_table
    rng = np.random.default_rng(5)
    vals = torch.from_numpy(
        (3.0 * rng.standard_normal((24, 70))).astype(np.float32)).to(tdt)
    got = ops.edge_gather_mix(vals, torch.from_numpy(table),
                              torch.from_numpy(valid))
    assert got.dtype == torch.float32
    want = jedge.edge_gather_mix(to_jax(vals), jnp.asarray(table),
                                 jnp.asarray(valid), interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    torch.testing.assert_close(
        got, ref.edge_gather_mix_ref(vals.float(), torch.from_numpy(table),
                                     torch.from_numpy(valid)),
        rtol=0, atol=0)


def packed_problem(hat):
    """A three-leaf tree (one leaf degenerate on row 1), its replica in
    ``hat`` and an initialized (N, G) quantizer state."""
    n = 4
    rng = np.random.default_rng(11)
    shapes = {"a": (n, 5, 6), "b": (n, 9), "c": (n, 3, 7)}
    theta = {k: (2.0 * rng.standard_normal(s)).astype(np.float32)
             for k, s in shapes.items()}
    qhat = {k: (v + 0.3 * rng.standard_normal(v.shape)).astype(np.float32)
            for k, v in theta.items()}
    tdt, jdt = NARROW[hat]
    # row 1 of leaf b does not move: theta equals its stored replica there
    theta["b"][1] = torch.from_numpy(qhat["b"][1]).to(tdt).float().numpy()
    g = 3
    side = dict(range_prev=rng.uniform(0.1, 2.0, (n, g)),
                bits_prev=rng.integers(2, 8, (n, g)).astype(np.float64),
                delta_prev=rng.uniform(0.01, 0.1, (n, g)),
                initialized=np.ones((n, g)))
    side = {k: v.astype(np.float32) for k, v in side.items()}
    st = E.GroupQuantState(
        q_hat={k: torch.from_numpy(v).to(tdt) for k, v in qhat.items()},
        **{k: torch.from_numpy(v) for k, v in side.items()})
    jst = JE.GroupQuantState(
        q_hat={k: jnp.asarray(v).astype(jdt) for k, v in qhat.items()},
        **{k: jnp.asarray(v) for k, v in side.items()})
    return ({k: torch.from_numpy(v) for k, v in theta.items()},
            {k: jnp.asarray(v) for k, v in theta.items()}, st, jst)


@pytest.mark.parametrize("hat", sorted(NARROW))
def test_packed_quantize_with_narrowed_q_hat_matches_jax(hat, monkeypatch):
    theta, jtheta, st, jst = packed_problem(hat)
    cfg = QuantConfig(b0=4, omega=0.99)
    key = jax.random.PRNGKey(7)
    pk = packing.make_packing(theta, (0, 1, 2))
    unif = torch.from_numpy(np.array(jax.random.uniform(
        key, (4, pk.dim), jnp.float32)))
    seen = []
    fused = ops.stoch_quantize_grouped_fused

    def spy(theta_p, qprev_p, *a, **kw):
        seen.append(qprev_p.dtype)
        return fused(theta_p, qprev_p, *a, **kw)

    monkeypatch.setattr(ops, "stoch_quantize_grouped_fused", spy)
    new, cand, bits, payload = E._grouped_quantize_step_packed(
        st, theta, unif, cfg, (0, 1, 2))
    jnew, jcand, jbits, jpayload = JE._grouped_quantize_step_packed(
        jst, jtheta, key, JQuant(b0=4, omega=0.99), (0, 1, 2))
    assert seen == [NARROW[hat][0]]          # packed in its own dtype
    for k in theta:
        assert new.q_hat[k].dtype == NARROW[hat][0]
        np.testing.assert_array_equal(
            to_torch(jnew.q_hat[k]).float().numpy(),
            new.q_hat[k].float().numpy(), err_msg=k)
    for f in ("range_prev", "bits_prev", "delta_prev"):
        np.testing.assert_array_equal(getattr(new, f).numpy(),
                                      np.asarray(getattr(jnew, f)), err_msg=f)
    np.testing.assert_array_equal(payload.numpy(), np.asarray(jpayload))
    # the degenerate group kept its replica bit for bit
    torch.testing.assert_close(new.q_hat["b"][1], st.q_hat["b"][1],
                               rtol=0, atol=0)


def test_tiled_route_widens_a_narrowed_q_hat_and_rounds_back(monkeypatch):
    theta, _, st, _ = packed_problem("bfloat16")
    cfg = QuantConfig(b0=4, omega=0.99)
    unif = torch.rand((4, packing.make_packing(theta, (0, 1, 2)).dim),
                      generator=torch.Generator().manual_seed(0))
    fused = E._grouped_quantize_step_packed(st, theta, unif, cfg, (0, 1, 2))
    monkeypatch.setenv("REPRO_QUANT_TILE_D", "16")
    tiled = E._grouped_quantize_step_packed(st, theta, unif, cfg, (0, 1, 2))
    for k in theta:
        torch.testing.assert_close(tiled[0].q_hat[k], fused[0].q_hat[k],
                                   rtol=0, atol=0)
    torch.testing.assert_close(tiled[2], fused[2], rtol=0, atol=0)


# --------------------------------------------------------- trajectories --
def jax_flat_uniforms(seed, iters, n=N, d=D):
    """The JAX engine's one-leaf draws (see test_torch_engine.py)."""
    def one(key):
        k1, k2 = jax.random.split(key)
        return jnp.stack([jax.random.uniform(k1, (n, d), jnp.float32),
                          jax.random.uniform(k2, (n, d), jnp.float32)])
    keys = jax.random.split(jax.random.PRNGKey(seed), iters)
    return np.asarray(jax.jit(jax.vmap(one))(keys))


def assert_bf16_paths_agree(got, want, jstar):
    """The trajectory rule of the module docstring; returns the first
    iteration whose replicas differ."""
    scale = np.abs(jstar).max()
    err = np.abs(got - want).max(axis=(1, 2))
    hats = [torch.from_numpy(np.ascontiguousarray(x)).bfloat16()
            for x in (got, want)]
    differ = (hats[0] != hats[1]).reshape(len(got), -1).any(axis=1).numpy()
    first = int(np.argmax(differ)) if differ.any() else len(got)
    assert (err[:first] <= 1e-4 * scale).all(), err[:first].max()
    assert (err <= 16 * BF16_STEP * scale).all(), (
        f"{err.max() / (BF16_STEP * scale):.1f} bf16 steps at iteration "
        f"{err.argmax()}")
    return first


def dist(theta, jstar):
    return ((theta - jstar[None]) ** 2).sum(axis=(-2, -1))


@pytest.mark.parametrize("backend", ["dense", "sparse"])
def test_ggadmm_bf16_replicas_match_jax(quick, backend):
    s, iters = quick, 150
    jcfg = dataclasses.replace(jab.ggadmm(rho=1.0), hat_dtype="bfloat16",
                               mix_backend=backend, use_pallas_mix=True)
    _, jout = JE.run(s["jgraph"], jcfg, JE.ExactSolver(s["jprob"]),
                     jnp.zeros((N, D), jnp.float32), iters,
                     extra_metrics=JE.flat_metrics(s["jgraph"], backend))
    cfg = dataclasses.replace(ab.ggadmm(rho=1.0), hat_dtype="bfloat16",
                              mix_backend=backend)
    st, out = E.run(s["graph"], cfg, E.ExactSolver(s["prob"]),
                    torch.zeros((N, D)), iters,
                    extra_metrics=E.flat_metrics(s["graph"], backend,
                                                 device="cpu"))
    assert st.theta_hat.dtype == st.alpha.dtype == torch.bfloat16
    got, want = out["theta"].numpy(), np.asarray(jout["theta"])
    first = assert_bf16_paths_agree(got, want, s["jstar"])
    assert first >= 5, first
    np.testing.assert_array_equal(out["tx_mask"].numpy(),
                                  np.asarray(jout["tx_mask"]))
    np.testing.assert_array_equal(out["payload_bits"].numpy(),
                                  np.asarray(jout["payload_bits"]))
    for d in (dist(got, s["jstar"]), dist(want, s["jstar"])):
        assert d[-1] <= 1e-3 * d[0], (d[0], d[-1])


def test_cq_ggadmm_bf16_replicas_match_jax_with_injected_uniforms(quick):
    s, iters = quick, 120
    jcfg = dataclasses.replace(jab.cq_ggadmm(rho=1.0), hat_dtype="bfloat16",
                               use_pallas_mix=True)
    _, jout = JE.run(s["jgraph"], jcfg, JE.ExactSolver(s["jprob"]),
                     jnp.zeros((N, D), jnp.float32), iters,
                     extra_metrics=JE.flat_metrics(s["jgraph"]))
    u = jax_flat_uniforms(0, iters)
    cfg = dataclasses.replace(ab.cq_ggadmm(rho=1.0), hat_dtype="bfloat16")
    st, out = E.run(s["graph"], cfg, E.ExactSolver(s["prob"]),
                    torch.zeros((N, D)), iters,
                    extra_metrics=E.flat_metrics(s["graph"], device="cpu"),
                    uniforms=lambda it, ph: torch.from_numpy(u[it, ph].copy()))
    assert st.quant.q_hat.dtype == torch.bfloat16
    got, want = out["theta"].numpy(), np.asarray(jout["theta"])
    first = assert_bf16_paths_agree(got, want, s["jstar"])
    assert first >= 3, first
    # the transmit decisions and bits agree while the replicas do
    np.testing.assert_array_equal(out["tx_mask"].numpy()[:first],
                                  np.asarray(jout["tx_mask"])[:first])
    np.testing.assert_array_equal(out["payload_bits"].numpy()[:first],
                                  np.asarray(jout["payload_bits"])[:first])
    bits = float(out["payload_bits"].sum())
    jbits = float(np.asarray(jout["payload_bits"]).sum())
    assert abs(bits - jbits) <= 0.03 * jbits, (bits, jbits)
    for d in (dist(got, s["jstar"]), dist(want, s["jstar"])):
        assert d[-1] <= 1e-3 * d[0], (d[0], d[-1])


def quadratic(n=6):
    """f_n(theta) = 0.5 ||theta - c_n||^2 over a two-leaf tree, optimum the
    mean of the c_n (JAX ``tests/test_consensus.py``), from numpy."""
    rng = np.random.default_rng(0)
    targets = {"w": rng.standard_normal((n, 4, 4)).astype(np.float32),
               "b": rng.standard_normal((n, 6)).astype(np.float32)}
    return targets, {k: v.mean(0) for k, v in targets.items()}


def test_sgd_local_solver_and_bf16_hats():
    """The port's analogue of JAX ``test_sgd_local_solver_and_bf16_hats``
    (same problem, config and assertions), with the JAX run's draws
    injected and its result beside it."""
    targets, opt = quadratic()
    tt = {k: torch.from_numpy(v) for k, v in targets.items()}
    jt = {k: jnp.asarray(v) for k, v in targets.items()}
    kw = dict(rho=0.5, local_steps=10, local_lr=0.3, use_adam=False,
              hat_dtype="bfloat16")
    g = random_bipartite_graph(6, 0.5, seed=0)
    jg = jax_graph(6, 0.5, seed=0)
    ccfg = C.ConsensusConfig(quantize=QuantConfig(b0=8, omega=0.995), **kw)
    jccfg = JC.ConsensusConfig(quantize=JQuant(b0=8, omega=0.995), **kw)
    state = C.init_consensus_state(T.tree_map(torch.zeros_like, tt), ccfg)
    jstate = JC.init_consensus_state(
        jax.tree_util.tree_map(jnp.zeros_like, jt), jccfg)
    assert state.opt_mu == () and jstate.opt_mu == ()
    assert state.theta_hat["b"].dtype == torch.bfloat16
    # the targets ride in the batch: the port's inexact solver hands the
    # gradient only the acting phase's rows
    step = C.make_consensus_step(g, ccfg, lambda th, b: T.tree_map(
        lambda x, c: x - c, th, b), device="cpu")
    jstep = jax.jit(JC.make_consensus_step(jg, jccfg, lambda th, b: (
        jax.tree_util.tree_map(lambda x, c: x - c, th, b))))
    for i in range(100):
        keys = jax.random.split(jax.random.PRNGKey(i))
        state, _ = step(state, lambda ph, keys=keys: torch.from_numpy(
            np.array(jax.random.uniform(keys[ph], (6, 22), jnp.float32))),
            tt)
        jstate, _ = jstep(jstate, jt, jax.random.PRNGKey(i))
    final = sum(float(((state.theta[k] - torch.from_numpy(o)[None]) ** 2
                       ).sum()) for k, o in opt.items())
    jfinal = sum(float(((np.asarray(jstate.theta[k]) - o[None]) ** 2).sum())
                 for k, o in opt.items())
    assert final < 0.1 and jfinal < 0.1, (final, jfinal)


def test_xlstm_smoke_bf16_replicas_match_jax():
    """xlstm-smoke, 4 workers, 2 steps, ``groups="leaf"``, cq-ggadmm with
    the JAX draws injected and bf16 replicas, float32 activations (as
    ``test_torch_consensus.py``): the replicas are bf16, the loss agrees to
    rel 1e-3 and the (N, G) bit widths of step 1 are equal (Eq. 18 on
    ranges of bf16 replicas that agree to float32 rounding)."""
    n, batch, seq, steps = 4, 4, 16, 2
    jcfg = jbase.get_smoke_config("xlstm-125m").with_overrides(
        dtype="float32")
    graph = JST.worker_graph(n, "random")
    ecfg = JE.EngineConfig(rho=0.01, censor=JCensor(tau0=5.0, xi=0.999),
                           quantize=JQuant(b0=6, omega=0.9995),
                           groups="leaf", hat_dtype="bfloat16")

    def grad_fn(theta, b):
        return jax.vmap(lambda p, bb: jax.grad(
            lambda pp: jregistry.lm_loss(pp, jcfg, bb)[0])(p))(theta, b)

    def loss_fn(theta, b):
        return jnp.mean(jax.vmap(
            lambda p, bb: jregistry.lm_loss(p, jcfg, bb)[0])(theta, b))

    solver = JE.InexactSolver(grad_fn=grad_fn, local_steps=2, local_lr=2e-3)
    one = jregistry.init_params(jcfg, jax.random.PRNGKey(0))
    jstate = JE.init_state(jax.tree_util.tree_map(
        lambda x: jnp.broadcast_to(x[None], (n,) + x.shape), one), ecfg,
        solver)
    jstep = jax.jit(JE.make_step(graph, ecfg, solver,
                                 extra_metrics=JE.consensus_metrics(loss_fn)))
    data = jlm.SyntheticLM(jlm.SyntheticLMConfig(jcfg.vocab_size, seq))
    jm = []
    for i in range(steps):
        b = jlm.model_batch(jcfg, data.worker_batch(i, n, batch // n),
                            key=jax.random.PRNGKey(i))
        jstate, m = jstep(jstate, b, jax.random.PRNGKey(1000 + i))
        jm.append(jax.tree_util.tree_map(np.asarray, m))

    params = interop.tree_from_numpy(
        {jax.tree_util.keystr(p): np.asarray(x) for p, x in
         jax.tree_util.tree_flatten_with_path(one)[0]}, device="cpu")
    cfg = base.get_smoke_config("xlstm-125m").with_overrides(dtype="float32")
    args = train.build_parser().parse_args(
        ["--arch", "xlstm-125m", "--smoke", "--workers", str(n), "--batch",
         str(batch), "--seq", str(seq), "--steps", str(steps),
         "--local-steps", "2", "--lr", "2e-3", "--tau0", "5.0", "--xi",
         "0.999", "--bits", "6", "--omega", "0.9995", "--groups", "leaf",
         "--device", "cpu", "--log-every", "1"])
    dim = sum(x.numel() for x in T.leaves(params))

    def uniforms(i, phase):
        k = jax.random.split(jax.random.PRNGKey(1000 + i))[phase]
        return torch.from_numpy(np.array(
            jax.random.uniform(k, (n, dim), jnp.float32)))

    out = train.run_admm(cfg, args, params=params, uniforms=uniforms,
                         hat_dtype="bfloat16")
    st = out["state"]
    for tree in (st.theta_hat, st.alpha, st.quant.q_hat):
        assert {x.dtype for x in T.leaves(tree)} == {torch.bfloat16}
    np.testing.assert_allclose(out["history"],
                               [float(m["loss"]) for m in jm], rtol=1e-3)
    np.testing.assert_array_equal(out["bits_per_group"][1],
                                  jm[1]["bits_per_group"])


def test_fleet_bf16_replicas_match_jax_fleetsim():
    """The faulted fleet (sparse backend, two leaves, participation 0.6,
    staleness 2) with bf16 replicas and the JAX draws injected against the
    JAX ``FleetSim`` with ``use_pallas_mix=True``: fault accounting equal,
    replicas bf16, theta by the trajectory rule of the docstring."""
    n, dim, rounds = 6, 12, 8
    x, y = R.partition_uniform(R.synth_linear(n=n * 30, d=dim, seed=0), n)
    jprob = JaxLinear(jnp.asarray(x), jnp.asarray(y))
    graph = random_bipartite_graph(n, 0.4, seed=0)
    kw = dict(groups="leaf", mix_backend="sparse", rho=1.0,
              hat_dtype="bfloat16")
    cfg = E.EngineConfig(censor=CensorConfig(tau0=0.5, xi=0.97),
                         quantize=QuantConfig(b0=2, omega=0.99), **kw)
    jcfg = JE.EngineConfig(censor=JCensor(tau0=0.5, xi=0.97),
                           quantize=JQuant(b0=2, omega=0.99),
                           use_pallas_mix=True, **kw)
    fc_kw = dict(participation=0.6, staleness=2, seed=1)
    jfs, jm = jsim.FleetSim(
        n, jcfg, jsim.FleetConfig(rounds=rounds, seed=2,
                                  faults=jfaults.FaultConfig(**fc_kw)),
        {"w": jnp.zeros((n, dim - 4)), "b": jnp.zeros((n, 4))},
        solver=JE.ExactSolver(jprob), graph0=graph).run()
    base_key = jax.random.PRNGKey(2)

    def uniforms(r, phase):
        k = jax.random.split(jax.random.fold_in(base_key, r))[phase]
        return torch.from_numpy(np.array(
            jax.random.uniform(k, (n, dim), jnp.float32)))

    fs, m = sim.FleetSim(
        n, cfg, sim.FleetConfig(rounds=rounds, seed=2,
                                faults=faults.FaultConfig(**fc_kw)),
        {"w": torch.zeros((n, dim - 4)), "b": torch.zeros((n, 4))},
        solver=E.ExactSolver(interop.problem_from_numpy(x, y, "linear",
                                                        device="cpu")),
        graph0=graph, uniforms=uniforms).run()
    assert fs.held_hat["w"].dtype == fs.engine.theta_hat["w"].dtype \
        == torch.bfloat16
    assert (m["fleet_participation"] == 0).any()
    for k in ("fleet_timer", "fleet_participation", "fleet_deliver",
              "tx_mask", "payload_bits", "censor_mask"):
        np.testing.assert_array_equal(m[k], np.asarray(jm[k]), err_msg=k)
    star = np.asarray(jprob.optimum())
    got = E._flatten_worker(fs.engine.theta).numpy()
    want = np.asarray(JE._flatten_worker(jfs.engine.theta))
    assert np.abs(got - want).max() <= 16 * BF16_STEP * np.abs(star).max()
