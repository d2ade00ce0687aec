"""The port's CUDA kernels against their plain versions, on the card.

Every test here is marked ``cuda`` and skips where there is no card. The
file imports neither JAX nor the JAX package, so it runs on a machine that
has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

The input builders and tolerance checks are shared with
``test_torch_kernels.py``, which holds the plain versions against JAX.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.kernels import ref

QUANT_SHAPES = [(24, 50), (7, 1), (64, 2000)]
MIX_SHAPES = [(24, 24, 50), (12, 24, 513)]


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
    float32 ulp of its boundary."""
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    diff = np.abs(got.astype(np.float64) - want.astype(np.float64))
    terms = np.abs(qprev.astype(np.float64)) + 2.0 * qrange[:, None]
    close = diff <= 1e-6 * terms
    if close.all():
        return
    sd = np.maximum(delta, np.float32(1e-12))[:, None]
    c = (theta - qprev + qrange[:, None]) / sd
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
