"""The port's CUDA kernels against their plain versions, on the card.

Every test here is marked ``cuda`` and skips where there is no card. The
file imports neither JAX nor the JAX package, so it runs on a machine that
has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

The input builders and tolerance checks are shared with
``test_torch_kernels.py``, which holds the plain versions against JAX.
"""
import functools

import numpy as np
import pytest
import torch

from repro_torch.configs import base
from repro_torch.core import packing
from repro_torch.core import tree as T
from repro_torch.kernels import ops
from repro_torch.kernels import ref
from repro_torch.models import registry

QUANT_SHAPES = [(24, 50), (7, 1), (64, 2000)]
MIX_SHAPES = [(24, 24, 50), (12, 24, 513)]


def _smoke_dims():
    tree = registry.init_params(base.get_smoke_config("xlstm-125m"),
                                device="meta")
    return tuple(int(np.prod(x.shape)) for x in T.leaves(tree))


# grouped layouts: (name, rows, per-leaf dims, leaf -> group ids,
# (row, group) pairs made degenerate)
GROUPED_LAYOUTS = {
    "flat-64x2000-G1": (64, (2000,), (0,), ()),
    "xlstm-smoke-G19": (4, _smoke_dims(), tuple(range(19)), ()),
    "ragged-5x4099": (5, (1000, 3, 1, 2048, 1047), (0, 1, 0, 2, 1),
                      ((0, 1), (3, 2))),
}


def grouped_inputs(n, dims, gids, seed, degenerate=()):
    """Packed (N, D) theta, q_prev, uniforms and (N, G) quantizer state as
    float32 numpy, plus the packing. Integer bit widths 2..8, some
    first-round and some zero-range groups; each (row, group) in
    ``degenerate`` has theta == q_prev on its columns (R = 0)."""
    tree = {f"k{i:02d}": torch.empty((n, d), device="meta")
            for i, d in enumerate(dims)}
    pk = packing.make_packing(tree, gids)
    rng = np.random.default_rng(seed)
    d_all, g = pk.dim, pk.n_groups
    theta = (3.0 * rng.standard_normal((n, d_all))).astype(np.float32)
    qprev = (3.0 * rng.standard_normal((n, d_all))).astype(np.float32)
    unif = rng.uniform(size=(n, d_all)).astype(np.float32)
    for row, grp in degenerate:
        cols = pk.col_group_ids == grp
        theta[row, cols] = qprev[row, cols]
    bits = rng.integers(2, 9, size=(n, g)).astype(np.float32)
    rprev = (rng.uniform(size=(n, g)) * 8.0).astype(np.float32)
    rprev[rng.uniform(size=(n, g)) < 0.2] = 0.0
    init = (rng.uniform(size=(n, g)) < 0.8).astype(np.float32)
    return (theta, qprev, unif, bits, rprev, init), pk


def boundary_inputs(omega=0.9995, n=48, d=300, seed=2):
    """Rows whose new range is exactly omega x the previous one, so the
    Eq. (18) argument 1 + (2^b - 1) R / (omega R_prev) lands on 2^b and
    ``ceil(log2(.))`` turns on the last bit of each rounding. Bit widths
    1..16. Float32 numpy, G=1."""
    rng = np.random.default_rng(seed)
    rprev = (0.1 + 5.0 * rng.uniform(size=(n, 1))).astype(np.float32)
    rnew = (np.float32(omega) * rprev).astype(np.float32)
    theta = (rnew * rng.uniform(-0.5, 0.5, size=(n, d))).astype(np.float32)
    theta[:, 0] = rnew[:, 0]
    qprev = np.zeros((n, d), np.float32)
    unif = rng.uniform(size=(n, d)).astype(np.float32)
    bits = (1 + np.arange(n) % 16).astype(np.float32)[:, None]
    return theta, qprev, unif, bits, rprev, np.ones((n, 1), np.float32)


def assert_grouped_close(got, want, args, pk):
    """(N, G) outputs bit for bit; ``out`` as ``assert_quant_close`` with
    each column's (Δ, R)."""
    out, rng_new, bits, delta = (np.asarray(x) for x in got)
    w_out, w_rng, w_bits, w_delta = (np.asarray(x) for x in want)
    np.testing.assert_array_equal(rng_new, w_rng)
    np.testing.assert_array_equal(bits, w_bits)
    np.testing.assert_array_equal(delta, w_delta)
    cols = pk.col_group_ids
    assert_quant_close(out, w_out, args[0], args[1], args[2],
                       w_delta[:, cols], w_rng[:, cols])


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda")


def quant_inputs(n, d, seed, degenerate_rows=()):
    """theta, q_prev, uniforms (N, d) and Δ, R (N,) as float32 numpy, with
    bit widths 2..8 per row; rows in ``degenerate_rows`` have R = Δ = 0."""
    rng = np.random.default_rng(seed)
    theta = (3.0 * rng.standard_normal((n, d))).astype(np.float32)
    qprev = (3.0 * rng.standard_normal((n, d))).astype(np.float32)
    unif = rng.uniform(size=(n, d)).astype(np.float32)
    for r in degenerate_rows:
        theta[r] = qprev[r]
    qrange = np.max(np.abs(theta - qprev), axis=1).astype(np.float32)
    bits = rng.integers(2, 9, size=n).astype(np.float32)
    delta = (np.float32(2.0) * qrange
             / (np.exp2(bits) - np.float32(1.0))).astype(np.float32)
    return theta, qprev, unif, delta, qrange


def assert_quant_close(got, want, theta, qprev, unif, delta, qrange):
    """Equal to rtol 1e-6 of the terms the output is summed from
    (``q_prev + Δq - R``, which can cancel to near zero; the Pallas
    interpret path contracts ``q_prev + Δq`` into an FMA, so its last
    rounding differs), except that a coordinate may differ by exactly one
    step Δ where the rounding decision ``u < frac(c)`` sits within one
    float32 ulp of its boundary. ``delta``/``qrange`` are (N,) per row or
    (N, D) per column."""
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    if delta.ndim == 1:
        delta, qrange = delta[:, None], qrange[:, None]
    diff = np.abs(got.astype(np.float64) - want.astype(np.float64))
    terms = np.abs(qprev.astype(np.float64)) + 2.0 * qrange
    close = diff <= 1e-6 * terms
    if close.all():
        return
    sd = np.broadcast_to(np.maximum(delta, np.float32(1e-12)), got.shape)
    c = (theta - qprev + qrange) / sd
    frac = c - np.floor(c)
    step = np.broadcast_to(sd, got.shape)
    bad = ~close
    one_step = np.abs(diff[bad] - step[bad]) <= 1e-5 * step[bad]
    boundary = np.abs(frac[bad] - unif[bad]) <= np.spacing(unif[bad])
    assert (one_step & boundary).all(), (
        f"{bad.sum()} coordinates differ beyond rtol 1e-6 and not by one "
        f"step at a rounding boundary")


def mix_inputs(m, n, d, seed):
    rng = np.random.default_rng(seed)
    adj = (rng.uniform(size=(m, n)) < 0.4).astype(np.float32)
    vals = rng.standard_normal((n, d)).astype(np.float32)
    return adj, vals


def assert_mix_close(got, want, adj, vals):
    """Summation order differs between implementations: hold each entry to
    1e-6 of the sum of the magnitudes of its terms."""
    scale = np.abs(adj).astype(np.float64) @ np.abs(vals).astype(np.float64)
    diff = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    assert (diff <= 1e-6 * scale + 1e-30).all(), diff.max()


@pytest.mark.cuda
@pytest.mark.parametrize("shape", QUANT_SHAPES + [(5, 4099)])
def test_stoch_quantize_kernel_matches_plain_on_card(cuda, shape):
    n, d = shape
    args = quant_inputs(n, d, seed=11, degenerate_rows=(0,))
    dev_args = [torch.from_numpy(a).to(cuda) for a in args]
    before = ops.launches["stoch_quantize"]
    got = ops.stoch_quantize(*dev_args)
    torch.cuda.synchronize()
    assert ops.launches["stoch_quantize"] == before + 1
    want = ref.stoch_quantize_ref(*dev_args)
    assert_quant_close(got.cpu().numpy(), want.cpu().numpy(), *args)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(70000, 3), (9, 1), (9, 3), (9, 5),
                                   (24, 50)])
@pytest.mark.parametrize("offset", [0, 1])
def test_stoch_quantize_flat_pass_on_card(cuda, shape, offset):
    """The flat pass past the first design's 65,535 rows, at widths that
    put row ends inside a group of 4, and with inputs one float into their
    buffers (the scalar body)."""
    n, d = shape
    args = quant_inputs(n, d, seed=n + d, degenerate_rows=(0, n - 1))
    dev_args = []
    for a in args:
        t = torch.from_numpy(a)
        if a.ndim == 2:
            buf = torch.empty(a.size + offset, device=cuda)
            t = buf[offset:].view(a.shape).copy_(t)
        dev_args.append(t.to(cuda))
    assert bool(dev_args[0].data_ptr() % 16) == bool(offset)
    got = ops.stoch_quantize(*dev_args)
    torch.cuda.synchronize()
    want = ref.stoch_quantize_ref(*dev_args)
    assert_quant_close(got.cpu().numpy(), want.cpu().numpy(), *args)
    np.testing.assert_array_equal(got.cpu().numpy()[[0, n - 1]],
                                  args[1][[0, n - 1]])


@pytest.mark.cuda
@pytest.mark.parametrize("shape", MIX_SHAPES + [(64, 64, 2000)])
def test_bipartite_mix_kernel_matches_plain_on_card(cuda, shape):
    m, n, d = shape
    adj, vals = mix_inputs(m, n, d, seed=5)
    before = ops.launches["bipartite_mix"]
    got = ops.bipartite_mix(torch.from_numpy(adj).to(cuda),
                            torch.from_numpy(vals).to(cuda))
    torch.cuda.synchronize()
    assert ops.launches["bipartite_mix"] == before + 1
    assert_mix_close(got.cpu().numpy(), adj @ vals, adj, vals)


# B2's regimes (M, N, d, storage offset of V in floats): the streaming
# design (M, N <= 8) with an odd d, an unaligned V and float4 columns past
# 2^24; the register-tiled design ragged, at 1,024 workers, and at 2,048
# (past the first design's 1,536-worker limit)
MIX_REGIMES = {"wide-odd-d": (4, 4, 2 ** 24 + 1, 0),
               "wide-unaligned": (4, 4, 2 ** 24 + 4, 1),
               "wide-float4": (4, 4, 2 ** 24 + 4, 0),
               "tiled-ragged": (12, 24, 513, 0),
               "tiled-1024": (1024, 1024, 2000, 0),
               "tiled-2048": (2048, 2048, 64, 0)}


def mix_on_card(m, n, d, offset, seed, device):
    """A 0/1 (M, N) adjacency and a contiguous (N, d) V starting
    ``offset`` floats into its buffer, seeded on the card."""
    gen = torch.Generator(device=device).manual_seed(seed)
    adj = (torch.rand((m, n), generator=gen, device=device) < 0.4).float()
    buf = torch.randn(n * d + offset, generator=gen, device=device)
    return adj, buf[offset:].view(n, d)


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(MIX_REGIMES))
def test_bipartite_mix_regimes_match_plain_on_card(cuda, case):
    """Each entry within 1e-6 of the sum of its terms' magnitudes (the
    plain ``A @ V`` sums in another order)."""
    m, n, d, offset = MIX_REGIMES[case]
    adj, vals = mix_on_card(m, n, d, offset, 13, cuda)
    assert vals.is_contiguous() and bool(vals.data_ptr() % 16) == bool(offset)
    before = ops.launches["bipartite_mix"]
    got = ops.bipartite_mix(adj, vals)
    torch.cuda.synchronize()
    assert ops.launches["bipartite_mix"] == before + 1
    want = ref.bipartite_mix_ref(adj, vals)
    scale = adj.double().abs() @ vals.double().abs()
    err = (got.double() - want.double()).abs()
    assert bool((err <= 1e-6 * scale + 1e-30).all()), float(err.max())


@pytest.mark.cuda
def test_bipartite_mix_designs_agree_bitwise_on_card(cuda):
    """Both designs compute each output as one fmaf chain over k in order:
    the streaming design's (8, 8) mix equals the first 8 rows of the tiled
    design's (9, 8) mix bit for bit, with float4 and with scalar columns."""
    for d in (4096, 4097):
        adj, vals = mix_on_card(9, 8, d, 0, 17, cuda)
        wide = ops.bipartite_mix(adj[:8].contiguous(), vals)
        tiled = ops.bipartite_mix(adj, vals)
        assert torch.equal(wide, tiled[:8])


@pytest.mark.cuda
def test_kernels_reject_what_they_do_not_take(cuda):
    x = torch.zeros((4, 8), device=cuda, dtype=torch.float64)
    r = torch.zeros(4, device=cuda)
    with pytest.raises(ValueError):
        ops.stoch_quantize(x, x, x, r, r)
    with pytest.raises(ValueError):
        ops.bipartite_mix(torch.zeros((4, 5), device=cuda),
                          torch.zeros((4, 8), device=cuda))


@pytest.mark.cuda
def test_engine_on_card_matches_engine_on_cpu(cuda):
    """A short ggadmm run on the card against the same run on the CPU."""
    from repro_torch import interop
    from repro_torch.core import admm_baselines as ab
    from repro_torch.core import engine as E
    from repro_torch.core.graph import random_bipartite_graph
    from repro_torch.data import regression as R

    x, y = R.partition_uniform(R.synth_linear(), 24)
    graph = random_bipartite_graph(24, 0.35, seed=0)
    thetas = []
    for dev in ("cpu", cuda):
        prob = interop.problem_from_numpy(x, y, "linear", device=dev)
        _, out = E.run(graph, ab.ggadmm(), E.ExactSolver(prob),
                       torch.zeros((24, 50), device=dev), 30,
                       extra_metrics=E.flat_metrics(graph, device=dev))
        thetas.append(out["theta"].cpu().numpy())
    err = np.abs(thetas[0] - thetas[1]).max()
    assert err <= 1e-4 * np.abs(thetas[0][-1]).max(), err


FUSED = {"fused": ops.stoch_quantize_grouped_fused,
         "tiled": lambda *a, **k: ops.stoch_quantize_grouped_fused_tiled(
             *a, block_d=512, **k)}


@pytest.mark.cuda
@pytest.mark.parametrize("variant", sorted(FUSED))
@pytest.mark.parametrize("layout", sorted(GROUPED_LAYOUTS))
def test_grouped_fused_kernels_match_plain_on_card(cuda, layout, variant):
    n, dims, gids, degen = GROUPED_LAYOUTS[layout]
    args, pk = grouped_inputs(n, dims, gids, seed=7, degenerate=degen)
    dev_args = [torch.from_numpy(a).to(cuda) for a in args]
    kw = dict(group_runs=pk.group_runs, omega=0.9995, b0=6, b_max=16)
    name = ("stoch_quantize_grouped_fused" if variant == "fused"
            else "stoch_quantize_grouped_fused_tiled")
    before = ops.launches[name]
    got = FUSED[variant](*dev_args, None, **kw)
    torch.cuda.synchronize()
    assert ops.launches[name] == before + 1
    gid = torch.from_numpy(pk.col_group_ids).to(cuda)
    want = ref.stoch_quantize_grouped_fused_ref(*dev_args, gid, **kw)
    assert_grouped_close([x.cpu() for x in got], [x.cpu() for x in want],
                         args, pk)
    for row, grp in degen:          # degenerate groups pass q_prev through
        cols = torch.from_numpy(pk.col_group_ids == grp).to(cuda)
        assert torch.equal(got[0][row][cols], dev_args[1][row][cols])


@pytest.mark.cuda
@pytest.mark.parametrize("variant", sorted(FUSED))
def test_fused_schedule_matches_plain_at_log2_boundaries(cuda, variant):
    args = boundary_inputs()
    dev_args = [torch.from_numpy(a).to(cuda) for a in args]
    runs = (((0, args[0].shape[1]),),)
    kw = dict(group_runs=runs, omega=0.9995, b0=2, b_max=16)
    got = FUSED[variant](*dev_args, None, **kw)
    want = ref.stoch_quantize_grouped_fused_ref(
        *dev_args, torch.zeros(args[0].shape[1], dtype=torch.int64,
                               device=cuda), **kw)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", sorted(GROUPED_LAYOUTS))
def test_tiled_kernel_equals_fused_kernel_on_card(cuda, layout):
    n, dims, gids, degen = GROUPED_LAYOUTS[layout]
    args, pk = grouped_inputs(n, dims, gids, seed=8, degenerate=degen)
    dev_args = [torch.from_numpy(a).to(cuda) for a in args]
    kw = dict(group_runs=pk.group_runs, omega=0.99, b0=2, b_max=16)
    fused = ops.stoch_quantize_grouped_fused(*dev_args, None, **kw)
    for tile in (512, 1000, 1 << 20):
        tiled = ops.stoch_quantize_grouped_fused_tiled(*dev_args, None,
                                                       block_d=tile, **kw)
        for a, b in zip(fused, tiled):
            assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", sorted(GROUPED_LAYOUTS))
def test_grouped_quant_kernel_matches_plain_on_card(cuda, layout):
    n, dims, gids, degen = GROUPED_LAYOUTS[layout]
    args, pk = grouped_inputs(n, dims, gids, seed=9, degenerate=degen)
    theta, qprev, unif = (torch.from_numpy(a).to(cuda) for a in args[:3])
    rng_new = ref.grouped_range_ref(theta - qprev, pk.group_runs)
    bits = torch.from_numpy(args[3]).to(cuda)
    delta = 2.0 * rng_new / (torch.exp2(bits) - 1.0)
    before = ops.launches["stoch_quantize_grouped"]
    got = ops.stoch_quantize_grouped(theta, qprev, unif, delta, rng_new, None,
                                     group_runs=pk.group_runs)
    torch.cuda.synchronize()
    assert ops.launches["stoch_quantize_grouped"] == before + 1
    gid = torch.from_numpy(pk.col_group_ids).to(cuda)
    want = ref.stoch_quantize_grouped_ref(theta, qprev, unif, delta, rng_new,
                                          gid)
    cols = pk.col_group_ids
    assert_quant_close(got.cpu().numpy(), want.cpu().numpy(), args[0],
                       args[1], args[2], delta.cpu().numpy()[:, cols],
                       rng_new.cpu().numpy()[:, cols])


@pytest.mark.cuda
def test_grouped_kernels_reject_what_they_do_not_take(cuda):
    args, pk = grouped_inputs(4, (10, 6), (0, 1), seed=1)
    dev_args = [torch.from_numpy(a).to(cuda) for a in args]
    kw = dict(omega=0.99, b0=2, b_max=16)
    with pytest.raises(ValueError, match="tile"):       # runs leave a gap
        ops.stoch_quantize_grouped_fused(*dev_args, None,
                                         group_runs=(((0, 10),), ((11, 5),)),
                                         **kw)
    with pytest.raises(ValueError):                     # float64 theta
        ops.stoch_quantize_grouped_fused(dev_args[0].double(),
                                         *dev_args[1:], None,
                                         group_runs=pk.group_runs, **kw)


# ------------------------------------------------ paged-attention decode --
# (B, H, KV, hd, ps, P): the smoke model's heads, tinyllama's heads, and a
# long table (256 pages of 16: the online kernel's own range)
@pytest.mark.cuda
def test_seed_stepper_on_card_equals_its_cpu_run(cuda):
    """The frozen seed stepper (B1 and B2 on the card) against its CPU run
    (the plain versions): ggadmm's trajectory within 1e-4 max|theta|; and
    cq-ggadmm on the card with injected draws equal to the engine on the
    card bit for bit, 2 B1 and 3 B2 launches an iteration."""
    from repro_torch import interop
    from repro_torch.core import admm_baselines as ab
    from repro_torch.core import cq_ggadmm
    from repro_torch.core import seed_reference as sr
    from repro_torch.core.graph import random_bipartite_graph
    from repro_torch.data import regression as R

    x, y = R.partition_uniform(R.synth_linear(), 24)
    graph = random_bipartite_graph(24, 0.35, seed=0)
    thetas = []
    for dev in ("cpu", cuda):
        prob = interop.problem_from_numpy(x, y, "linear", device=dev)
        state, _ = sr.run(graph, prob, ab.ggadmm(), 50, 30, device=dev)
        thetas.append(state.theta.cpu().numpy())
    err = np.abs(thetas[0] - thetas[1]).max()
    assert err <= 1e-4 * np.abs(thetas[0]).max(), err

    rng = np.random.default_rng(4)
    draws = rng.uniform(size=(10, 2, 24, 50)).astype(np.float32)

    def uniforms(it, phase):
        return torch.from_numpy(draws[it, phase])

    prob = interop.problem_from_numpy(x, y, "linear", device=cuda)
    cfg = ab.cq_ggadmm(rho=1.0)
    before = dict(ops.launches)
    st_s, out_s = sr.run(graph, prob, cfg, 50, 10, uniforms=uniforms,
                         device=cuda)
    torch.cuda.synchronize()
    assert ops.launches["stoch_quantize"] - before["stoch_quantize"] == 20
    assert ops.launches["bipartite_mix"] - before["bipartite_mix"] == 30
    st_e, out_e = cq_ggadmm.run(graph, prob, cfg, 50, 10, uniforms=uniforms,
                                device=cuda)
    np.testing.assert_array_equal(out_e["tx_mask"], out_s["tx_mask"])
    np.testing.assert_array_equal(out_e["candidate_payload_bits"],
                                  out_s["payload_bits"])
    assert torch.equal(st_e.theta, st_s.theta)
    assert torch.equal(st_e.quant.q_hat, st_s.quant.q_hat)


@pytest.mark.cuda
def test_perleaf_loop_on_card_equals_its_plain_run(cuda):
    """The multi-leaf per-leaf loop (one B1 launch a leaf) against the same
    step on the CPU: ranges and bit widths equal, each leaf within the
    quantizer's tolerance."""
    from repro_torch.core import engine as E
    from repro_torch.core.quantization import QuantConfig

    shapes = {"a": (6, 5), "b": (6, 3, 40), "c": (6, 700), "d": (6, 1)}
    gids, cfg = (0, 1, 0, 2), QuantConfig(b0=3, omega=0.9)
    rng = np.random.default_rng(5)
    tree = {k: (3.0 * rng.standard_normal(s)).astype(np.float32)
            for k, s in shapes.items()}
    qprev = {k: (3.0 * rng.standard_normal(s)).astype(np.float32)
             for k, s in shapes.items()}
    qprev["d"][2] = tree["d"][2]                 # a degenerate group
    draws = [rng.uniform(size=s).astype(np.float32)
             for s in shapes.values()]
    outs = []
    for dev in ("cpu", cuda):
        state = E.GroupQuantState.create(
            {k: torch.from_numpy(v).to(dev) for k, v in tree.items()}, 3,
            b0=3)
        state = E.GroupQuantState(
            q_hat={k: torch.from_numpy(v).to(dev) for k, v in qprev.items()},
            range_prev=state.range_prev + 1.0, bits_prev=state.bits_prev,
            delta_prev=state.delta_prev,
            initialized=torch.ones_like(state.initialized))
        before = ops.launches["stoch_quantize"]
        new, q, bits, pay = E.grouped_quantize_step_unfused(
            state, {k: torch.from_numpy(v).to(dev) for k, v in tree.items()},
            [torch.from_numpy(u).to(dev) for u in draws], cfg, gids)
        torch.cuda.synchronize()
        launched = ops.launches["stoch_quantize"] - before
        outs.append((new, q, bits, pay, launched))
    (cpu, cq, cbits, cpay, _), (card, gq, gbits, gpay, launched) = outs
    assert launched == len(shapes)
    np.testing.assert_array_equal(gbits.cpu().numpy(), cbits.numpy())
    np.testing.assert_array_equal(gpay.cpu().numpy(), cpay.numpy())
    np.testing.assert_array_equal(card.range_prev.cpu().numpy(),
                                  cpu.range_prev.numpy())
    rng_, delta = cpu.range_prev.numpy(), cpu.delta_prev.numpy()
    for i, (k, s) in enumerate(shapes.items()):
        g, n = gids[i], s[0]
        flat = (lambda a: np.asarray(a, np.float32).reshape(n, -1))
        assert_quant_close(flat(gq[k].cpu()), flat(cq[k]), flat(tree[k]),
                           flat(qprev[k]), flat(draws[i]), delta[:, g],
                           rng_[:, g])


PAGED_SHAPES = {"smoke": (3, 8, 2, 32, 4, 16),
                "tinyllama": (8, 32, 4, 64, 16, 64),
                "tinyllama-long": (8, 32, 4, 64, 16, 256),
                # the serve-smoke campaign's model: 8-token pages, 11-page
                # tables (17 prompt + 64 new tokens)
                "serve-smoke-ps8": (4, 8, 2, 64, 8, 11)}


def paged_inputs(bsz, heads, num_kv, hd, ps, pps, kv_bits, seed, *,
                 pool_dtype=torch.float32, ctx=None):
    """Numpy-seeded decode inputs as CPU tensors: q (B, H, hd), K/V pools
    (bsz * pps + 3 pages) as values in ``pool_dtype`` (kv_bits 32) or as
    ``ref.kv_page_quantize`` codes with their ranges, a block table of
    distinct pages whose slots past ctx are poisoned (-1, or ids past the
    pool), and ctx lens with 0 (an inactive slot), 1 and the full table.
    Returns (kwargs for ``ops.paged_attention_decode``, max |V| as the
    kernel reads it)."""
    rng = np.random.default_rng(seed)
    num_pages = bsz * pps + 3
    q = rng.standard_normal((bsz, heads, hd)).astype(np.float32)
    k = rng.standard_normal((num_pages, ps, num_kv, hd)).astype(np.float32)
    v = (2.0 * rng.standard_normal((num_pages, ps, num_kv, hd))
         ).astype(np.float32)
    if ctx is None:
        ctx = rng.integers(1, pps * ps + 1, size=bsz)
        ctx[0] = 0
        ctx[-1] = pps * ps
        if bsz > 2:
            ctx[1] = 1
    ctx = np.asarray(ctx, np.int32)
    bt = rng.permutation(num_pages)[:bsz * pps].reshape(bsz, pps)
    bt = bt.astype(np.int32)
    for b in range(bsz):
        used = -(-int(ctx[b]) // ps)
        bt[b, used::2] = -1
        bt[b, used + 1::2] = num_pages + 7
    kw = dict(q=torch.from_numpy(q), block_tables=torch.from_numpy(bt),
              ctx_lens=torch.from_numpy(ctx), kv_bits=kv_bits)
    if kv_bits == 32:
        kw.update(k_pages=torch.from_numpy(k).to(pool_dtype),
                  v_pages=torch.from_numpy(v).to(pool_dtype))
        vmax = float(kw["v_pages"].float().abs().max())
    else:
        kc, kr = ref.kv_page_quantize(torch.from_numpy(k), kv_bits=kv_bits)
        vc, vr = ref.kv_page_quantize(torch.from_numpy(v), kv_bits=kv_bits)
        kw.update(k_pages=kc, v_pages=vc, k_scale=kr, v_scale=vr)
        vmax = float(ref.kv_page_dequantize(vc, vr, kv_bits=kv_bits,
                                            head_dim=hd).abs().max())
    return kw, vmax


def paged_call(fn, kw, device):
    kw = {k: (x.to(device) if isinstance(x, torch.Tensor) else x)
          for k, x in kw.items()}
    return fn(kw.pop("q"), kw.pop("k_pages"), kw.pop("v_pages"),
              kw.pop("block_tables"), kw.pop("ctx_lens"), **kw)


PAGED_CASES = [(shape, bits, dt) for shape in sorted(PAGED_SHAPES)
               for bits, dt in ((32, torch.float32), (32, torch.bfloat16),
                                (8, None), (4, None))]


@pytest.mark.cuda
@pytest.mark.parametrize("online", [False, True])
@pytest.mark.parametrize("shape,kv_bits,pool_dtype", PAGED_CASES)
def test_paged_attention_kernels_match_plain_on_card(cuda, monkeypatch,
                                                     shape, kv_bits,
                                                     pool_dtype, online):
    """B7 (one-shot) and B8 (online) against their plain versions on the
    card to 1e-5 of max|V| (float32 sums in another order), with poisoned
    tables and ctx 0, 1 and full; B8 against B7 where ctx > 0."""
    monkeypatch.setenv("REPRO_PAGED_ATTN_ONLINE", "1" if online else "0")
    kw, vmax = paged_inputs(*PAGED_SHAPES[shape], kv_bits, seed=3,
                            pool_dtype=pool_dtype or torch.float32)
    name = ("paged_attention_decode_online" if online
            else "paged_attention_decode")
    before = ops.launches[name]
    got = paged_call(ops.paged_attention_decode, kw, cuda)
    torch.cuda.synchronize()
    assert ops.launches[name] == before + 1
    plain = (ref.paged_attention_online_ref if online
             else ref.paged_attention_ref)
    want = paged_call(plain, kw, cuda)
    err = float((got - want).abs().max())
    assert err <= 1e-5 * vmax, (err, vmax)
    if online:
        assert torch.equal(got[0], torch.zeros_like(got[0]))   # ctx = 0
        monkeypatch.setenv("REPRO_PAGED_ATTN_ONLINE", "0")
        oneshot = paged_call(ops.paged_attention_decode, kw, cuda)
        err = float((got[1:] - oneshot[1:]).abs().max())
        assert err <= 1e-5 * vmax, (err, vmax)


def split_edges(pages, page_size):
    """ctx on and around the split kernel's split boundaries, every one
    live, clipped to the table."""
    from repro_torch.kernels import paged_attention
    rows, full = paged_attention.SPLIT_ROWS, pages * page_size
    ctx = [1, rows - 1, rows, rows + 1, 2 * rows, 2 * rows + 1, full - 1,
           full]
    return [min(c, full) for c in ctx]


@pytest.mark.cuda
@pytest.mark.parametrize("pages", [64, 256])
@pytest.mark.parametrize("kv_bits,pool_dtype", [
    (32, torch.float32), (32, torch.bfloat16), (8, None), (4, None)])
@pytest.mark.parametrize("online", [True, False])
def test_online_kernel_at_split_boundaries_on_card(cuda, monkeypatch, online,
                                                   pages, kv_bits,
                                                   pool_dtype):
    """B8 (online) and B7 (one-shot) at tinyllama's heads with all eight
    sequences live, ctx on and around split boundaries: within 1e-5 of
    max|V| of their plain versions; a second identical call gives the same
    output bit for bit (the last split to arrive set its ticket counter
    back to 0)."""
    monkeypatch.setenv("REPRO_PAGED_ATTN_ONLINE", "1" if online else "0")
    name = ("paged_attention_decode_online" if online
            else "paged_attention_decode")
    kw, vmax = paged_inputs(8, 32, 4, 64, 16, pages, kv_bits, seed=9,
                            pool_dtype=pool_dtype or torch.float32,
                            ctx=split_edges(pages, 16))
    before = ops.launches[name]
    got = paged_call(ops.paged_attention_decode, kw, cuda)
    again = paged_call(ops.paged_attention_decode, kw, cuda)
    torch.cuda.synchronize()
    assert ops.launches[name] == before + 2
    plain = (ref.paged_attention_online_ref if online
             else ref.paged_attention_ref)
    want = paged_call(plain, kw, cuda)
    err = float((got - want).abs().max())
    assert err <= 1e-5 * vmax, (err, vmax)
    assert torch.equal(got, again)


@pytest.mark.cuda
@pytest.mark.parametrize("kv_bits,pool_dtype", [
    (32, torch.float32), (32, torch.bfloat16), (8, None), (4, None)])
@pytest.mark.parametrize("shape", ["smoke", "tinyllama"])
def test_oneshot_kernel_at_ctx_zero_is_the_uniform_average_on_card(
        cuda, monkeypatch, shape, kv_bits, pool_dtype):
    """B7 where ctx = 0: the mean of V over every slot of the clamped
    table (poisoned ids and all), within 1e-5 of max|V|, finite; its
    neighbours (ctx 1 and the full table) still match the plain version;
    a repeated call is equal bit for bit."""
    monkeypatch.setenv("REPRO_PAGED_ATTN_ONLINE", "0")
    bsz, heads, num_kv, hd, ps, pps = PAGED_SHAPES[shape]
    ctx = ([0, 1, 0, pps * ps] + [0] * bsz)[:bsz]
    kw, vmax = paged_inputs(bsz, heads, num_kv, hd, ps, pps, kv_bits,
                            seed=11, pool_dtype=pool_dtype or torch.float32,
                            ctx=ctx)
    got = paged_call(ops.paged_attention_decode, kw, cuda)
    again = paged_call(ops.paged_attention_decode, kw, cuda)
    want = paged_call(ref.paged_attention_ref, kw, cuda)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all())
    assert torch.equal(got, again)
    assert float((got - want).abs().max()) <= 1e-5 * vmax
    num_pages = kw["k_pages"].shape[0]
    bt = torch.clamp(kw["block_tables"].long(), 0, num_pages - 1)
    if kv_bits == 32:
        v = kw["v_pages"][bt].float()
    else:
        v = ref.kv_page_dequantize(kw["v_pages"][bt], kw["v_scale"][bt],
                                   kv_bits=kv_bits, head_dim=hd)
    # (B, P, ps, KV, hd) -> per KV head, the mean over all P·ps slots
    mean = v.reshape(bsz, pps * ps, num_kv, hd).mean(1)
    uniform = mean.repeat_interleave(heads // num_kv, dim=1)
    zero = torch.tensor(ctx) == 0
    err = float((got.cpu()[zero] - uniform[zero]).abs().max())
    assert err <= 1e-5 * vmax, (err, vmax)


@pytest.mark.cuda
@pytest.mark.parametrize("heads,num_kv,hd", [(32, 2, 64), (32, 1, 32),
                                             (24, 2, 32)])
@pytest.mark.parametrize("online", [False, True])
def test_paged_attention_more_query_heads_than_a_block_on_card(
        cuda, monkeypatch, online, heads, num_kv, hd):
    """16, 32 and 12 query heads per KV head: each KV head takes several
    blocks of at most 8 query heads; both contracts match their plain
    versions to 1e-5 of max|V|, with ctx 0, 1 and the full table."""
    monkeypatch.setenv("REPRO_PAGED_ATTN_ONLINE", "1" if online else "0")
    kw, vmax = paged_inputs(3, heads, num_kv, hd, 16, 8, 32, seed=13,
                            pool_dtype=torch.bfloat16)
    got = paged_call(ops.paged_attention_decode, kw, cuda)
    plain = (ref.paged_attention_online_ref if online
             else ref.paged_attention_ref)
    want = paged_call(plain, kw, cuda)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    assert err <= 1e-5 * vmax, (err, vmax)


@pytest.mark.cuda
def test_paged_attention_threshold_picks_the_variant_on_card(cuda,
                                                             monkeypatch):
    """Without an override, a 64-page tinyllama table takes the one-shot
    kernel and a 256-page one the online kernel."""
    monkeypatch.delenv("REPRO_PAGED_ATTN_ONLINE", raising=False)
    for shape, name in (("tinyllama", "paged_attention_decode"),
                        ("tinyllama-long", "paged_attention_decode_online")):
        kw, _ = paged_inputs(*PAGED_SHAPES[shape], 32, seed=4,
                             pool_dtype=torch.bfloat16)
        ops.reset_launches()
        paged_call(ops.paged_attention_decode, kw, cuda)
        torch.cuda.synchronize()
        assert ops.launches == {k: int(k == name) for k in ops.KERNELS}


# a shared system prompt of 32 pages (phase 19's 512 tokens) mapped by
# rows 0-5 of one table; row 6 maps it too, with its last page forked
# mid-page (write_pos 501); row 7 has a table of its own
ALIAS_SHARED, ALIAS_WRITE_POS = 32, 31 * 16 + 5


def aliased_inputs(kv_bits, pool_dtype=torch.float32, *, poison=False,
                   seed=21, heads=32, num_kv=4, hd=64):
    """Decode inputs at tinyllama's heads (B 8, H 32, KV 4, hd 64, pages
    of 16; ``heads``, ``num_kv`` and ``hd`` give others) and the
    production-load stream's 84-page tables (contexts from
    the stream's 529 to its 1,340, and on the split edges at 1,280, where
    the last of 11 splits is half filled) whose block-table rows alias
    physical pages:
    rows 0-5 map the same 32 prefix pages, then pages of their own; row 6
    maps the first 31 and a fork F of the 32nd, holding the donor's K/V
    below ``ALIAS_WRITE_POS``, its own token at it and the donor's stale
    tokens past it (masked by its ctx, 502, as ``fork_pages`` masks them
    in ``kv_pos``). ``poison`` fills F's slots past the write point with
    1e3 instead (codes 255 and ranges 1e3 in code pools): a kernel that
    reads them changes its output. Returns (kwargs for
    ``ops.paged_attention_decode``, max |V| as the kernel reads it)."""
    bsz, ps, pps = 8, 16, 84
    rng = np.random.default_rng(seed)
    num_pages = bsz * pps
    k = rng.standard_normal((num_pages, ps, num_kv, hd)).astype(np.float32)
    v = (2.0 * rng.standard_normal((num_pages, ps, num_kv, hd))
         ).astype(np.float32)
    q = rng.standard_normal((bsz, heads, hd)).astype(np.float32)
    free = iter(rng.permutation(num_pages).tolist())
    prefix = [next(free) for _ in range(ALIAS_SHARED)]
    bt = np.full((bsz, pps), -1, np.int32)
    ctx = np.array([1340, 529, 1281, 1279, 512, 1280, ALIAS_WRITE_POS + 1,
                    1212], np.int32)
    for b in range(bsz):
        used = -(-int(ctx[b]) // ps)
        own = [next(free) for _ in range(used)]
        bt[b, :used] = own
        if b <= 6:
            bt[b, :ALIAS_SHARED] = prefix
    fork = next(free)                        # F, row 6's last page
    bt[6, ALIAS_SHARED - 1] = fork
    k[fork], v[fork] = k[prefix[-1]], v[prefix[-1]]
    slot = ALIAS_WRITE_POS % ps
    k[fork, slot] = rng.standard_normal((num_kv, hd))
    v[fork, slot] = 2.0 * rng.standard_normal((num_kv, hd))
    if poison and kv_bits == 32:
        k[fork, slot + 1:] = 1e3
        v[fork, slot + 1:] = 1e3
    kw = dict(q=torch.from_numpy(q), block_tables=torch.from_numpy(bt),
              ctx_lens=torch.from_numpy(ctx), kv_bits=kv_bits)
    if kv_bits == 32:
        kw.update(k_pages=torch.from_numpy(k).to(pool_dtype),
                  v_pages=torch.from_numpy(v).to(pool_dtype))
        return kw, float(kw["v_pages"].float().abs().max())
    kc, kr = ref.kv_page_quantize(torch.from_numpy(k), kv_bits=kv_bits)
    vc, vr = ref.kv_page_quantize(torch.from_numpy(v), kv_bits=kv_bits)
    vmax = float(ref.kv_page_dequantize(vc, vr, kv_bits=kv_bits,
                                        head_dim=hd).abs().max())
    if poison:
        for codes, ranges in ((kc, kr), (vc, vr)):
            codes[fork, slot + 1:] = 255
            ranges[fork, slot + 1:] = 1e3
    kw.update(k_pages=kc, v_pages=vc, k_scale=kr, v_scale=vr)
    return kw, vmax


ALIAS_POOLS = [(32, torch.bfloat16), (32, torch.float32), (8, None),
               (4, None)]


@pytest.mark.cuda
@pytest.mark.parametrize("kv_bits,pool_dtype", ALIAS_POOLS)
@pytest.mark.parametrize("online", [False, True])
def test_paged_attention_on_aliased_and_forked_pages_on_card(
        cuda, monkeypatch, online, kv_bits, pool_dtype):
    """B7 and B8 on tables whose rows share physical pages (prefix
    sharing) and on a page forked mid-page: within 1e-5 of max|V| of the
    plain version, a repeated call equal bit for bit, and the forked
    page's stale slots past the write point never read (poisoning them
    leaves the output bit for bit)."""
    monkeypatch.setenv("REPRO_PAGED_ATTN_ONLINE", "1" if online else "0")
    name = ("paged_attention_decode_online" if online
            else "paged_attention_decode")
    kw, vmax = aliased_inputs(kv_bits, pool_dtype or torch.float32)
    bad, _ = aliased_inputs(kv_bits, pool_dtype or torch.float32,
                            poison=True)
    before = ops.launches[name]
    got = paged_call(ops.paged_attention_decode, kw, cuda)
    again = paged_call(ops.paged_attention_decode, kw, cuda)
    poisoned = paged_call(ops.paged_attention_decode, bad, cuda)
    torch.cuda.synchronize()
    assert ops.launches[name] == before + 3
    plain = (ref.paged_attention_online_ref if online
             else ref.paged_attention_ref)
    want = paged_call(plain, kw, cuda)
    err = float((got - want).abs().max())
    assert err <= 1e-5 * vmax, (err, vmax)
    assert torch.equal(got, again)
    assert torch.equal(got, poisoned)


# (B, H, KV, hd, ps, P) at the wider head dims of the served configs:
# h2o-danube (80, G 4), zamba2 (112, G 1), olmoe (128, G 1), mistral-large
# (128, G 12: three blocks of 4 query heads a KV head), qwen2-vl (128, G 7:
# two blocks), gemma3's global layers (256, G 2)
WIDE_SHAPES = {"h2o-danube": (4, 32, 8, 80, 16, 32),
               "zamba2": (4, 32, 32, 112, 16, 32),
               "olmoe": (4, 16, 16, 128, 16, 32),
               "mistral-large": (4, 96, 8, 128, 16, 32),
               "qwen2-vl": (4, 28, 4, 128, 16, 32),
               "gemma3": (8, 8, 4, 256, 16, 32)}
WIDE_POOLS = [(32, torch.float32), (32, torch.bfloat16), (8, None),
              (4, None)]


@pytest.mark.cuda
@pytest.mark.parametrize("kv_bits,pool_dtype", WIDE_POOLS)
@pytest.mark.parametrize("shape", sorted(WIDE_SHAPES))
@pytest.mark.parametrize("online", [False, True])
def test_paged_attention_at_wider_head_dims_on_card(cuda, monkeypatch,
                                                   online, shape, kv_bits,
                                                   pool_dtype):
    """B7 and B8 at head dims 80, 112, 128 and 256, every pool kind: ctx
    0, then on and around the split edges, within 1e-5 of max|V| of the
    plain version; a repeated call equal bit for bit; the one-shot contract
    at ctx 0 finite."""
    monkeypatch.setenv("REPRO_PAGED_ATTN_ONLINE", "1" if online else "0")
    bsz, heads, num_kv, hd, ps, pps = WIDE_SHAPES[shape]
    edges = [0] + split_edges(pps, ps)
    for lo in range(0, len(edges), bsz):
        ctx = (edges[lo:lo + bsz] + [pps * ps] * bsz)[:bsz]
        kw, vmax = paged_inputs(bsz, heads, num_kv, hd, ps, pps, kv_bits,
                                seed=31 + lo, ctx=ctx,
                                pool_dtype=pool_dtype or torch.float32)
        got = paged_call(ops.paged_attention_decode, kw, cuda)
        again = paged_call(ops.paged_attention_decode, kw, cuda)
        plain = (ref.paged_attention_online_ref if online
                 else ref.paged_attention_ref)
        want = paged_call(plain, kw, cuda)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        assert err <= 1e-5 * vmax, (shape, ctx, err, vmax)
        assert torch.equal(got, again)
        assert bool(torch.isfinite(got).all())


@pytest.mark.cuda
@pytest.mark.parametrize("kv_bits,pool_dtype", ALIAS_POOLS)
@pytest.mark.parametrize("shape", sorted(WIDE_SHAPES))
@pytest.mark.parametrize("online", [False, True])
def test_paged_attention_aliased_pages_at_wider_head_dims_on_card(
        cuda, monkeypatch, online, shape, kv_bits, pool_dtype):
    """The aliased and forked tables of the production-load stream at the
    wider head dims: within 1e-5 of max|V| of the plain version, and the
    fork's stale slots never read."""
    monkeypatch.setenv("REPRO_PAGED_ATTN_ONLINE", "1" if online else "0")
    _, heads, num_kv, hd, _, _ = WIDE_SHAPES[shape]
    dims = dict(heads=heads, num_kv=num_kv, hd=hd)
    kw, vmax = aliased_inputs(kv_bits, pool_dtype or torch.float32, **dims)
    bad, _ = aliased_inputs(kv_bits, pool_dtype or torch.float32,
                            poison=True, **dims)
    got = paged_call(ops.paged_attention_decode, kw, cuda)
    poisoned = paged_call(ops.paged_attention_decode, bad, cuda)
    plain = (ref.paged_attention_online_ref if online
             else ref.paged_attention_ref)
    want = paged_call(plain, kw, cuda)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    assert err <= 1e-5 * vmax, (err, vmax)
    assert torch.equal(got, poisoned)


@pytest.mark.cuda
def test_paged_attention_rejects_what_it_does_not_take(cuda):
    kw, _ = paged_inputs(*PAGED_SHAPES["smoke"], 8, seed=5)
    kw = {k: (x.to(cuda) if isinstance(x, torch.Tensor) else x)
          for k, x in kw.items()}
    with pytest.raises(ValueError, match="k_scale"):
        ops.paged_attention_decode(kw["q"], kw["k_pages"], kw["v_pages"],
                                   kw["block_tables"], kw["ctx_lens"],
                                   kv_bits=8)
    with pytest.raises(ValueError):                 # float64 pools
        ops.paged_attention_decode(kw["q"], kw["k_pages"].double(),
                                   kw["v_pages"].double(),
                                   kw["block_tables"], kw["ctx_lens"])
    wide, _ = paged_inputs(2, 4, 2, 96, 4, 4, 32, seed=6)
    with pytest.raises(ValueError, match="head_dim"):
        paged_call(ops.paged_attention_decode, wide, cuda)


# ------------------------------------------------------ edge_gather_mix --
def _edge_graphs():
    from repro_torch.core import graph as G
    from repro_torch.runtime import steps as ST
    return {"6-odd-d": (G.random_bipartite_graph(6, 0.5, seed=1), 7),
            "paper-24": (G.random_bipartite_graph(24, 0.35, seed=0), 50),
            "full-64": (G.random_bipartite_graph(64, 0.35, seed=0), 2000),
            "star-257": (G.star_graph(257), 2000),
            "random-1024": (G.random_bipartite_graph(1024, 0.05, seed=0),
                            256),
            "lm-4": (ST.worker_graph(4), 1 << 20)}


EDGE_SHAPES = ["6-odd-d", "paper-24", "full-64", "star-257", "random-1024",
               "lm-4"]


def edge_inputs(g, d, seed, device):
    table, valid = g.neighbor_table
    vals = torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (g.n, d)).astype(np.float32))
    return (vals.to(device), torch.from_numpy(table).to(device),
            torch.from_numpy(valid).to(device))


@pytest.mark.cuda
@pytest.mark.parametrize("name", EDGE_SHAPES)
def test_edge_gather_mix_kernel_matches_plain_bitwise_on_card(cuda, name):
    g, d = _edge_graphs()[name]
    vals, table, valid = edge_inputs(g, d, 3, cuda)
    before = ops.launches["edge_gather_mix"]
    got = ops.edge_gather_mix(vals, table, valid)
    torch.cuda.synchronize()
    assert ops.launches["edge_gather_mix"] == before + 1
    want = ref.edge_gather_mix_ref(vals, table, valid)
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_edge_gather_mix_poisoned_table_and_scalar_path_on_card(cuda):
    """Pad ids out of range at both ends, NaN/inf in the rows they clamp
    to, and 16-byte-unaligned rows (the scalar path): bit for bit."""
    from repro_torch.core import graph as G
    g = G.random_bipartite_graph(6, 0.5, seed=1)
    table, valid = (x.copy() for x in g.neighbor_table)
    pads = valid == 0
    table[pads] = np.resize(np.array([7, -3, 100, -1], np.int32),
                            int(pads.sum()))
    vals = np.random.default_rng(3).standard_normal((6, 64)).astype(
        np.float32)
    vals[0, 2], vals[5, 1] = np.nan, np.inf
    t, v = torch.from_numpy(table).to(cuda), torch.from_numpy(valid).to(cuda)
    dense = torch.from_numpy(vals).to(cuda)
    unaligned = torch.empty(6 * 64 + 1, device=cuda)[1:].view(6, 64)
    unaligned.copy_(dense)
    assert unaligned.data_ptr() % 16 != 0
    want = ref.edge_gather_mix_ref(dense, t, v)
    for x in (dense, unaligned):
        got = ops.edge_gather_mix(x, t, v)
        torch.cuda.synchronize()
        assert torch.equal(got.isnan(), want.isnan())
        assert torch.equal(torch.nan_to_num(got), torch.nan_to_num(want))
    assert bool(want.isnan().any())


# B6's regimes: (N, table, validity, d, storage offset of V in floats).
# Each is run as plan() picks it and forced into the other design where
# that one fits
def _random_table(n, s, seed):
    """An (N, S) table of random ids, pad slots (valid 0) out of range."""
    rng = np.random.default_rng(seed)
    table = rng.integers(0, n, size=(n, s)).astype(np.int32)
    valid = (rng.uniform(size=(n, s)) < 0.7).astype(np.float32)
    table[valid == 0] = rng.integers(-5, n + 5, size=int((valid == 0).sum()))
    return n, table, valid


@functools.lru_cache(maxsize=1)
def _edge_regime_cases():
    from repro_torch.core import graph as G
    from repro_torch.kernels import edge_gather_mix as EG

    def of(g):
        return (g.n, *g.neighbor_table)

    n_switch = EG.STAGE_CAP // (4 * 16)         # float4 rows, d = 2000
    return {
        "full-64": (*of(G.random_bipartite_graph(64, 0.35, seed=0)), 2000,
                    0),
        "star-257": (*of(G.star_graph(257)), 2000, 0),
        "random-1024": (*of(G.random_bipartite_graph(1024, 0.05, seed=0)),
                        2000, 0),
        "lm-4-loop": (*of(G.complete_bipartite_graph(2, 2)), 4 * 64 * 4300,
                      0),
        "switch-1": (*_random_table(n_switch - 1, 9, 2), 2000, 0),
        "switch": (*of(G.star_graph(n_switch)), 2000, 0),
        "switch+1": (*_random_table(n_switch + 1, 9, 3), 2000, 0),
        "s-1": (*_random_table(500, 1, 5), 2000, 0),
        "unaligned": (*of(G.random_bipartite_graph(64, 0.35, seed=0)), 2000,
                      1),
        "n-70000": (*_random_table(70000, 3, 4), 3, 0),
        "weights": (*_weighted(_random_table(64, 27, 6)), 2000, 0),
    }


def _weighted(case):
    """Weights other than 0 and 1 (the kernels' general product-then-add
    walk; 0/1 weights take one fmaf a slot)."""
    n, table, valid = case
    pick = np.array([0.0, 0.37, 1.0, -2.5], np.float32)
    return n, table, pick[np.arange(valid.size).reshape(valid.shape) % 4]


EDGE_REGIMES = ["full-64", "star-257", "random-1024", "lm-4-loop",
                "switch-1", "switch", "switch+1", "s-1", "unaligned",
                "n-70000", "weights"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", EDGE_REGIMES)
def test_edge_gather_mix_regimes_match_plain_bitwise_on_card(cuda, name):
    """Bit for bit with the plain version through the entry point (the
    plan's regime), and in each design forced where it fits: S = 1, a V
    view one float into its buffer (scalar units), N past 65,535."""
    from repro_torch.kernels import edge_gather_mix as EG
    n, table, valid, d, offset = _edge_regime_cases()[name]
    table, valid = torch.from_numpy(table).to(cuda), torch.from_numpy(
        valid).to(cuda)
    gen = torch.Generator(device=cuda).manual_seed(len(name))
    buf = torch.randn(n * d + offset, generator=gen, device=cuda)
    vals = buf[offset:].view(n, d)
    assert bool(vals.data_ptr() % 16) == bool(offset)
    want = ref.edge_gather_mix_ref(vals, table, valid)
    before = ops.launches["edge_gather_mix"]
    got = ops.edge_gather_mix(vals, table, valid)
    torch.cuda.synchronize()
    assert ops.launches["edge_gather_mix"] == before + 1
    assert torch.equal(got, want)
    s = table.shape[1]
    picked = EG.plan(n, s, d, not offset)
    if name == "s-1":
        assert s == 1
    for regime in ("staged", "gather"):
        try:
            p = EG.plan(n, s, d, not offset, regime)
        except ValueError:
            assert picked.regime == "gather"    # too large to stage
            continue
        out = torch.full_like(vals, float("nan"))
        EG.launch(vals, table, valid, out, p)
        torch.cuda.synchronize()
        assert torch.equal(out, want), regime


@pytest.mark.cuda
def test_sparse_mix_equals_dense_mix_on_card(cuda):
    """On a 0/1 graph B6 (products by 1.0, adds in ascending neighbor
    order) and B2 (an FMA chain over all workers in ascending order, the
    0.0 terms adding nothing) round the same sums the same way."""
    from repro_torch.core import graph as G
    from repro_torch.core import topology
    g = G.random_bipartite_graph(64, 0.35, seed=0)
    vals = edge_inputs(g, 2000, 5, cuda)[0]
    sparse = topology.build(g, "sparse", device=cuda)
    dense = topology.build(g, "dense", device=cuda)
    assert torch.equal(sparse.mix(vals), dense.mix(vals))
    assert torch.equal(sparse.laplacian(vals), dense.laplacian(vals))


@pytest.mark.cuda
def test_edge_gather_mix_rejects_what_it_does_not_take(cuda):
    vals = torch.zeros((4, 8), device=cuda)
    table = torch.zeros((4, 2), dtype=torch.int32, device=cuda)
    valid = torch.ones((4, 2), device=cuda)
    with pytest.raises(ValueError):                      # int64 table
        ops.edge_gather_mix(vals, table.long(), valid)
    with pytest.raises(ValueError):                      # table on the CPU
        ops.edge_gather_mix(vals, table.cpu(), valid)
    with pytest.raises(ValueError):                      # rows mismatch
        ops.edge_gather_mix(vals, table[:3], valid[:3])


# ---------------------------------------------------------- B9 slstm_cell --
def cell_inputs(shape, m0, seed, wx_dtype=np.float32):
    """sLSTM cell inputs as float32 numpy: wx (B, S, H, 4dh) (rounded to
    bf16 values first when ``wx_dtype`` is "bfloat16"), R (H, dh, 4dh),
    fbias (H, dh) and a state (B, H, dh) x 4. ``m0`` "fresh" is the
    contiguous cache's -1e30 with a zero state, "admitted" the paged
    admission's all-zero state, "carried" a state from mid-sequence."""
    b, s, h, dh = shape
    rng = np.random.default_rng(seed)
    wx = (0.5 * rng.standard_normal((b, s, h, 4 * dh))).astype(np.float32)
    if wx_dtype == "bfloat16":
        wx = torch.from_numpy(wx).to(torch.bfloat16).float().numpy()
    r_w = (rng.standard_normal((h, dh, 4 * dh)) / np.sqrt(dh)).astype(
        np.float32)
    fb = np.full((h, dh), 3.0, np.float32)
    zero = np.zeros((b, h, dh), np.float32)
    if m0 == "fresh":
        state = (zero, zero, np.full_like(zero, -1e30), zero)
    elif m0 == "admitted":
        state = (zero, zero, zero, zero)
    else:
        state = (rng.standard_normal((b, h, dh)).astype(np.float32),
                 (1.0 + rng.uniform(size=(b, h, dh))).astype(np.float32),
                 rng.standard_normal((b, h, dh)).astype(np.float32),
                 (0.5 * rng.standard_normal((b, h, dh))).astype(np.float32))
    return (wx, r_w, fb) + state


def cell_tensors(args, device, wx_dtype=torch.float32):
    ts = [torch.from_numpy(a).to(device) for a in args]
    ts[0] = ts[0].to(wx_dtype)
    return ts


def cell_errors(got, want):
    """max |got - want| of hs and of each final state (c, n, m, h), and
    max |hs| of ``want``."""
    errs = [float((got[0] - want[0]).abs().max())]
    errs += [float((a - b).abs().max()) for a, b in zip(got[1], want[1])]
    return errs, float(want[0].abs().max())


# (B, S, H, dh), initial state, wx dtype: an odd batch and length;
# xlstm-125m's heads at the lockstep and paged prefill shapes; nine rows
# from a carried state
SLSTM_CASES = [((3, 129, 2, 16), "admitted", torch.float32),
               ((8, 96, 4, 192), "fresh", torch.bfloat16),
               ((1, 64, 4, 192), "admitted", torch.float32),
               ((9, 33, 4, 64), "carried", torch.bfloat16),
               ((2, 9, 1, 256), "carried", torch.float32)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,m0,wx_dtype", SLSTM_CASES)
def test_slstm_cell_kernel_matches_plain_on_card(cuda, shape, m0, wx_dtype):
    """B9 against its plain version on the same card tensors: hs and every
    final state within 1e-4 of max|hs| (the kernel sums h R with fmaf in
    k order, the plain version through cuBLAS)."""
    args = cell_tensors(cell_inputs(shape, m0, sum(shape)), cuda, wx_dtype)
    before = ops.launches["slstm_cell"]
    got = ops.slstm_cell(*args)
    again = ops.slstm_cell(*args)
    assert ops.launches["slstm_cell"] == before + 2
    want = ref.slstm_cell_ref(*args)
    torch.cuda.synchronize()
    errs, hmax = cell_errors(got, want)
    assert max(errs) <= 1e-4 * hmax, (errs, hmax)
    assert tuple(got[0].shape) == shape[:2] + (shape[2], shape[3])
    # a repeated call is equal bit for bit
    assert all(torch.equal(a, b) for a, b in zip((got[0],) + got[1],
                                                 (again[0],) + again[1]))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(8, 40, 4, 192), (3, 17, 2, 256),
                                   (5, 21, 3, 64)])
def test_slstm_cell_row_tiles_agree_bitwise_on_card(cuda, shape):
    """B9 with 1, 2, 4 and 8 batch rows per cluster (each cluster's rows
    run the same arithmetic): every output equal bit for bit."""
    from repro_torch.kernels.slstm_cell import ROW_CHOICES, slstm_cell_cuda

    args = cell_tensors(cell_inputs(shape, "carried", 4), cuda,
                        torch.bfloat16)
    outs = [slstm_cell_cuda(*args, rows=rows) for rows in ROW_CHOICES]
    torch.cuda.synchronize()
    for o in outs[1:]:
        assert all(torch.equal(a, b) for a, b in zip(
            (outs[0][0],) + outs[0][1], (o[0],) + o[1]))


@pytest.mark.cuda
def test_slstm_cell_rejects_what_it_does_not_take(cuda):
    from repro_torch.kernels.slstm_cell import slstm_cell_cuda

    args = cell_tensors(cell_inputs((2, 5, 2, 16), "fresh", 0), cuda)
    bad = [
        [args[0].half()] + args[1:],                       # float16 wx
        [args[0], args[1].double()] + args[2:],            # float64 R
        [args[0].transpose(0, 1).contiguous().transpose(0, 1)]
        + args[1:],                                        # non-contiguous
        args[:3] + [args[3].cpu()] + args[4:],             # c0 on the CPU
        [args[0][..., :60]] + args[1:],                    # 4dh mismatch
    ]
    for call in bad:
        with pytest.raises(ValueError):
            ops.slstm_cell(*call)
    with pytest.raises(ValueError, match="CUDA"):
        slstm_cell_cuda(*[a.cpu() for a in args])
    wide = cell_tensors(cell_inputs((1, 2, 1, 264), "fresh", 0), cuda)
    with pytest.raises(ValueError, match="head width"):
        ops.slstm_cell(*wide)


@pytest.mark.cuda
def test_xlstm_scheduler_runs_b9_per_bulk_chunk_on_card(cuda):
    """The smoke xLSTM served by the paged scheduler on the card: one B9
    launch per sLSTM layer per bulk prefill chunk, none in decode, and no
    page left in use."""
    from repro_torch.serving.scheduler import Scheduler, ServeConfig

    cfg = base.get_smoke_config("xlstm-125m")
    params = registry.init_params(
        cfg, torch.Generator(device=cuda).manual_seed(0), device=cuda)
    sched = Scheduler(cfg, params, ServeConfig(
        max_seqs=3, page_size=4, num_pages=48, pages_per_seq=16,
        prefill_chunk=4), device=cuda)
    rng = np.random.default_rng(0)
    for n, m in zip((9, 17, 5, 13), (5, 3, 6, 4)):
        sched.submit(rng.integers(0, cfg.vocab_size, n), m)
    ops.reset_launches()
    with torch.no_grad():
        sched.run()
    n_slstm = cfg.block_kinds.count("slstm")
    assert sched.prefill_chunks > 0
    assert ops.launches["slstm_cell"] == n_slstm * sched.prefill_chunks
    assert sched.pool.in_use == 0


# ------------------------------------------------------ narrowed storage --
# B2, B6 and B3 on bf16 and f16 replicas (the engine's hat_dtype): each the
# float32 kernel on the widened values, rounded once to the storage type,
# bit for bit (a narrowed value widens exactly; the float32 chain is the
# same, and __float2bfloat16_rn / __float2half_rn round as torch's .to()).
NARROW_DTYPES = [torch.bfloat16, torch.float16]

# (M, N, d, storage offset of V in values): both B2 designs, 16-byte rows,
# odd and misaligned rows (scalar loads), 1,024 workers
NARROW_MIX = {"convex": (64, 64, 2000, 0), "ragged": (12, 24, 513, 0),
              "wide-16B": (4, 4, 2 ** 20 + 8, 0),
              "wide-odd": (4, 4, 1001, 0),
              "wide-unaligned": (4, 4, 2 ** 20 + 8, 1),
              "tiled-unaligned": (64, 64, 2000, 3),
              "tiled-1024": (1024, 1024, 2000, 0)}


def narrow_values(n, d, offset, dtype, seed, device):
    """A contiguous (N, d) V of ``dtype`` starting ``offset`` values into
    its buffer (offset 1 or 3: rows off the 16-byte boundary)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    buf = (3.0 * torch.randn(n * d + offset, generator=gen,
                             device=device)).to(dtype)
    return buf[offset:].view(n, d)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", NARROW_DTYPES, ids=str)
@pytest.mark.parametrize("case", sorted(NARROW_MIX))
def test_bipartite_mix_narrowed_is_the_float32_route_on_card(cuda, case,
                                                             dtype):
    m, n, d, offset = NARROW_MIX[case]
    gen = torch.Generator(device=cuda).manual_seed(5)
    adj = (torch.rand((m, n), generator=gen, device=cuda) < 0.4).float()
    vals = narrow_values(n, d, offset, dtype, 3, cuda)
    before = ops.launches["bipartite_mix"]
    got = ops.bipartite_mix(adj, vals)
    want = ops.bipartite_mix(adj, vals.float()).to(dtype)
    torch.cuda.synchronize()
    assert ops.launches["bipartite_mix"] == before + 2
    assert got.dtype == dtype and torch.equal(got, want)
    # the plain version rounds the library's float32 product once: one
    # step of the storage type apart at most (its sum order differs)
    plain = ref.bipartite_mix_ref(adj, vals).float()
    assert bool(((got.float() - plain).abs()
                 <= torch.finfo(dtype).eps * got.float().abs()).all())


EDGE_NARROW = ["full-64", "star-257", "random-1024", "lm-4-loop", "s-1",
               "unaligned", "n-70000", "weights"]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", NARROW_DTYPES, ids=str)
@pytest.mark.parametrize("name", EDGE_NARROW)
def test_edge_gather_mix_reads_narrowed_values_on_card(cuda, name, dtype):
    """B6 on narrowed V equals B6 on V.float() bit for bit, through the
    entry point and in each design forced where it fits; the plan's regime
    and geometry are those of float32 V (only the shared memory halves)."""
    from repro_torch.kernels import edge_gather_mix as EG
    n, table, valid, d, offset = _edge_regime_cases()[name]
    table, valid = torch.from_numpy(table).to(cuda), torch.from_numpy(
        valid).to(cuda)
    vals = narrow_values(n, d, offset, dtype, len(name), cuda)
    aligned = vals.data_ptr() % 8 == 0
    assert aligned == (not offset)
    before = ops.launches["edge_gather_mix"]
    got = ops.edge_gather_mix(vals, table, valid)
    want = ops.edge_gather_mix(vals.float(), table, valid)
    torch.cuda.synchronize()
    assert ops.launches["edge_gather_mix"] == before + 2
    assert got.dtype == torch.float32 and torch.equal(got, want)
    s = table.shape[1]
    for regime in (None, "staged", "gather"):
        try:
            p32 = EG.plan(n, s, d, aligned, regime)
        except ValueError:
            continue
        p16 = EG.plan(n, s, d, aligned, regime, elem=2)
        assert p16._replace(smem=0) == p32._replace(smem=0)
        assert p16.smem <= p32.smem
        if regime is None:
            continue
        out = torch.full((n, d), float("nan"), device=cuda)
        EG.launch(vals, table, valid, out, p16)
        torch.cuda.synchronize()
        assert torch.equal(out, want), regime


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", NARROW_DTYPES, ids=str)
@pytest.mark.parametrize("layout", sorted(GROUPED_LAYOUTS))
def test_grouped_fused_narrowed_q_hat_is_the_float32_route_on_card(
        cuda, layout, dtype):
    """B3 with a narrowed q_prev equals B3 on q_prev.float(): out rounded
    once to the storage type, the (N, G) outputs bit for bit; the tiled
    route (B4 through the engine's casts) gives the same."""
    n, dims, gids, degen = GROUPED_LAYOUTS[layout]
    args, pk = grouped_inputs(n, dims, gids, seed=9, degenerate=degen)
    dev = [torch.from_numpy(a).to(cuda) for a in args]
    qn = dev[1].to(dtype)
    for row, grp in degen:      # theta equals the stored replica there
        cols = torch.from_numpy(pk.col_group_ids == grp).to(cuda)
        dev[0][row, cols] = qn[row, cols].float()
    kw = dict(group_runs=pk.group_runs, omega=0.9995, b0=6, b_max=16)
    before = ops.launches["stoch_quantize_grouped_fused"]
    got = ops.stoch_quantize_grouped_fused(dev[0], qn, *dev[2:], None, **kw)
    want = ops.stoch_quantize_grouped_fused(dev[0], qn.float(), *dev[2:],
                                            None, **kw)
    tiled = ops.stoch_quantize_grouped_fused_tiled(dev[0], qn, *dev[2:], None,
                                                   block_d=512, **kw)
    torch.cuda.synchronize()
    assert ops.launches["stoch_quantize_grouped_fused"] == before + 2
    assert got[0].dtype == dtype and torch.equal(got[0], want[0].to(dtype))
    for a, b in zip(got[1:], want[1:]):
        assert torch.equal(a, b)
    for a, b in zip(tiled, got):
        assert torch.equal(a, b)
    for row, grp in degen:
        cols = torch.from_numpy(pk.col_group_ids == grp).to(cuda)
        assert torch.equal(got[0][row][cols], qn[row][cols])
