"""The plain versions of the three grouped quantize kernels and the
engine's packed quantize step, against the JAX package on the CPU.

* Plain versions (``kernels/ref.py``) against ``repro.kernels.ref``: bit
  for bit, the same operations in the same order.
* Against the Pallas kernels in interpret mode: the interpret path
  contracts ``q_prev + Δq`` into an FMA on the CPU (ROADMAP.md C), so
  ``out`` is held to the one-Δ-at-a-rounding-boundary rule of
  ``assert_quant_close`` and the (N, G) outputs are bitwise.
* The packed engine step (fused and two-pass) against the JAX package's
  ``_grouped_quantize_step_packed`` with the same uniforms.

The CUDA kernels are held against these plain versions on the card in
``test_torch_cuda.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engine as JE
from repro.core.quantization import QuantConfig as JQuantConfig
from repro.kernels import ref as jref
from repro.kernels import stoch_quant as jsq
from repro_torch.core import engine as E
from repro_torch.core import tree as T
from repro_torch.core.quantization import QuantConfig
from repro_torch.kernels import ops, ref
from test_torch_cuda import (GROUPED_LAYOUTS, assert_grouped_close,
                             assert_quant_close, boundary_inputs,
                             grouped_inputs)

KW = dict(omega=0.9995, b0=6, b_max=16)


def _jax_fused_ref(args, pk):
    return jref.stoch_quantize_grouped_fused_ref(
        *(jnp.asarray(a) for a in args), jnp.asarray(pk.col_group_ids),
        group_runs=pk.group_runs, **KW)


@pytest.mark.parametrize("layout", sorted(GROUPED_LAYOUTS))
def test_fused_plain_matches_jax_ref_bitwise(layout):
    n, dims, gids, degen = GROUPED_LAYOUTS[layout]
    args, pk = grouped_inputs(n, dims, gids, seed=3, degenerate=degen)
    got = ref.stoch_quantize_grouped_fused_ref(
        *(torch.from_numpy(a) for a in args),
        torch.from_numpy(pk.col_group_ids), group_runs=pk.group_runs, **KW)
    want = _jax_fused_ref(args, pk)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    for row, grp in degen:
        cols = pk.col_group_ids == grp
        np.testing.assert_array_equal(got[0].numpy()[row, cols],
                                      args[1][row, cols])


def test_fused_plain_matches_jax_ref_at_log2_boundaries():
    """The Eq. (18) argument on 2^b exactly: the schedule's bits depend on
    the last rounding of log(x) / ln 2, which both packages divide."""
    args = boundary_inputs()
    gid = np.zeros(args[0].shape[1], np.int32)
    runs = (((0, args[0].shape[1]),),)
    got = ref.stoch_quantize_grouped_fused_ref(
        *(torch.from_numpy(a) for a in args), torch.from_numpy(gid),
        group_runs=runs, **KW)
    want = jref.stoch_quantize_grouped_fused_ref(
        *(jnp.asarray(a) for a in args), jnp.asarray(gid), group_runs=runs,
        **KW)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert len(np.unique(got[2].numpy())) > 8       # many bit widths hit


@pytest.mark.parametrize("layout", ["ragged-5x4099", "flat-64x2000-G1"])
def test_fused_plain_matches_pallas_interpret(layout):
    n, dims, gids, degen = GROUPED_LAYOUTS[layout]
    args, pk = grouped_inputs(n, dims, gids, seed=4, degenerate=degen)
    got = ref.stoch_quantize_grouped_fused_ref(
        *(torch.from_numpy(a) for a in args),
        torch.from_numpy(pk.col_group_ids), group_runs=pk.group_runs, **KW)
    jargs = [jnp.asarray(a) for a in args] + [jnp.asarray(pk.col_group_ids)]
    slab = jsq.stoch_quantize_grouped_fused(
        *jargs, group_runs=pk.group_runs, interpret=True, **KW)
    tiled = jsq.stoch_quantize_grouped_fused_tiled(
        *jargs, block_d=512, interpret=True, **KW)
    for want in (slab, tiled):
        assert_grouped_close([g.numpy() for g in got], want, args, pk)


@pytest.mark.parametrize("layout", sorted(GROUPED_LAYOUTS))
def test_grouped_plain_matches_jax_ref_and_pallas(layout):
    n, dims, gids, degen = GROUPED_LAYOUTS[layout]
    args, pk = grouped_inputs(n, dims, gids, seed=5, degenerate=degen)
    theta, qprev, unif = args[:3]
    rng_new = jref.grouped_range_ref(jnp.asarray(theta - qprev),
                                     pk.group_runs)
    np.testing.assert_array_equal(
        ref.grouped_range_ref(torch.from_numpy(theta - qprev),
                              pk.group_runs).numpy(), np.asarray(rng_new))
    delta = np.asarray(2.0 * rng_new / (jnp.exp2(jnp.asarray(args[3]))
                                        - 1.0), np.float32)
    rng_np = np.asarray(rng_new)
    gid = pk.col_group_ids
    got = ref.stoch_quantize_grouped_ref(
        *(torch.from_numpy(a.copy())
          for a in (theta, qprev, unif, delta, rng_np)),
        torch.from_numpy(gid))
    want = jref.stoch_quantize_grouped_ref(
        *(jnp.asarray(a) for a in (theta, qprev, unif, delta, rng_np, gid)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if layout != "xlstm-smoke-G19":     # interpret mode is slow at 7.6M
        pallas = jsq.stoch_quantize_grouped(
            *(jnp.asarray(a) for a in (theta, qprev, unif, delta, rng_np,
                                       gid)), interpret=True)
        assert_quant_close(got.numpy(), pallas, theta, qprev, unif,
                           delta[:, gid], rng_np[:, gid])
    # G=1 is the flat stoch_quantize_ref bit for bit
    one = ref.stoch_quantize_grouped_ref(
        *(torch.from_numpy(a.copy()) for a in (theta, qprev, unif, delta[:, :1],
                                        rng_np[:, :1])),
        torch.zeros(theta.shape[1], dtype=torch.int64))
    flat = ref.stoch_quantize_ref(
        *(torch.from_numpy(a) for a in (theta, qprev, unif, delta[:, 0],
                                        rng_np[:, 0])))
    assert torch.equal(one, flat)


def test_ops_cpu_path_takes_plain_versions_and_counts_nothing(monkeypatch):
    n, dims, gids, degen = GROUPED_LAYOUTS["ragged-5x4099"]
    args, pk = grouped_inputs(n, dims, gids, seed=6, degenerate=degen)
    targs = [torch.from_numpy(a) for a in args]
    before = dict(ops.launches)
    want = ref.stoch_quantize_grouped_fused_ref(
        *targs, torch.from_numpy(pk.col_group_ids), group_runs=pk.group_runs,
        **KW)
    for tile in ("0", "512"):           # REPRO_QUANT_TILE_D routing
        monkeypatch.setenv("REPRO_QUANT_TILE_D", tile)
        got = ops.stoch_quantize_grouped_fused(
            *targs, None, group_runs=pk.group_runs, **KW)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    got = ops.stoch_quantize_grouped(targs[0], targs[1], targs[2], want[3],
                                     want[1], None, group_runs=pk.group_runs)
    assert torch.equal(got, ref.stoch_quantize_grouped_ref(
        targs[0], targs[1], targs[2], want[3], want[1],
        torch.from_numpy(pk.col_group_ids)))
    assert ops.launches == before


def _toy_state(seed, n=4):
    """A worker-stacked multi-leaf tree and a mid-run quantizer state, in
    both packages."""
    rng = np.random.default_rng(seed)
    flat = {"['a']": (n, 7), "['b']": (n, 6, 5), "['c']['w']": (n, 3)}
    vals = {k: (3.0 * rng.standard_normal(s)).astype(np.float32)
            for k, s in flat.items()}
    qvals = {k: (3.0 * rng.standard_normal(s)).astype(np.float32)
             for k, s in flat.items()}
    vals["['c']['w']"][1] = qvals["['c']['w']"][1]    # a degenerate group
    to_t = lambda d: T.from_paths({k: torch.from_numpy(v.copy())  # noqa
                                   for k, v in d.items()})
    to_j = lambda d: {"a": jnp.asarray(d["['a']"]),  # noqa: E731
                      "b": jnp.asarray(d["['b']"]),
                      "c": {"w": jnp.asarray(d["['c']['w']"])}}
    side = {"range_prev": rng.uniform(size=(n, 3)).astype(np.float32),
            "bits_prev": rng.integers(2, 9, size=(n, 3)).astype(np.float32),
            "delta_prev": rng.uniform(size=(n, 3)).astype(np.float32),
            "initialized": np.ones((n, 3), np.float32)}
    pq = E.GroupQuantState(q_hat=to_t(qvals),
                           **{k: torch.from_numpy(v) for k, v in side.items()})
    jq = JE.GroupQuantState(q_hat=to_j(qvals),
                            **{k: jnp.asarray(v) for k, v in side.items()})
    dim = sum(int(np.prod(s[1:])) for s in flat.values())
    unif = rng.uniform(size=(n, dim)).astype(np.float32)
    return to_t(vals), to_j(vals), pq, jq, unif


def test_packed_engine_step_matches_jax_and_twopass(monkeypatch):
    ptheta, jtheta, pq, jq, unif = _toy_state(0)
    ids = (0, 1, 2)
    cfg, jcfg = QuantConfig(b0=6, omega=0.999), JQuantConfig(b0=6, omega=0.999)
    # the JAX packed step draws its uniforms from a key: hand it ours
    monkeypatch.setattr(jax.random, "uniform",
                        lambda key, shape, dtype: jnp.asarray(unif))
    jnew, jcand, jbits, jpay = JE._grouped_quantize_step_packed(
        jq, jtheta, None, jcfg, ids)
    monkeypatch.undo()
    u = torch.from_numpy(unif)
    new, cand, bits, pay = E.grouped_quantize_step(pq, ptheta, u, cfg, ids)
    two = E.grouped_quantize_step_twopass(pq, ptheta, u, cfg, ids)
    np.testing.assert_array_equal(bits.numpy(), np.asarray(jbits))
    np.testing.assert_array_equal(pay.numpy(), np.asarray(jpay))
    for f in ("range_prev", "bits_prev", "delta_prev", "initialized"):
        np.testing.assert_array_equal(getattr(new, f).numpy(),
                                      np.asarray(getattr(jnew, f)))
        assert torch.equal(getattr(two[0], f), getattr(new, f))
    np.testing.assert_array_equal(cand["c"]["w"].numpy()[1],
                                  pq.q_hat["c"]["w"].numpy()[1])
    for path, leaf in T.to_paths(cand).items():
        want = {"['a']": jcand["a"], "['b']": jcand["b"],
                "['c']['w']": jcand["c"]["w"]}[path]
        np.testing.assert_array_equal(leaf.numpy(), np.asarray(want))
        assert torch.equal(T.to_paths(two[1])[path], leaf)
    assert torch.equal(two[3], pay)
