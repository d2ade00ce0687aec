"""The port's kernels' plain versions against the JAX package's, on the
CPU: against ``repro.kernels.ref`` and the Pallas kernels in interpret
mode. The CUDA kernels are held against these plain versions on the card
in ``test_torch_cuda.py``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.bipartite_mix import bipartite_mix as pallas_mix
from repro.kernels.stoch_quant import stoch_quantize as pallas_quant
from repro_torch.kernels import ref
from test_torch_cuda import (MIX_SHAPES, QUANT_SHAPES, assert_mix_close,
                             assert_quant_close, mix_inputs, quant_inputs)


@pytest.mark.parametrize("shape", QUANT_SHAPES)
def test_stoch_quantize_ref_matches_jax_ref_and_pallas(shape):
    n, d = shape
    args = quant_inputs(n, d, seed=n * 7919 + d)
    got = ref.stoch_quantize_ref(*(torch.from_numpy(a) for a in args))
    want_ref = jref.stoch_quantize_ref(*(jnp.asarray(a) for a in args))
    want_pallas = pallas_quant(*(jnp.asarray(a) for a in args),
                               interpret=True)
    assert got.dtype == torch.float32 and tuple(got.shape) == shape
    # the same operations in the same order as the JAX plain version
    np.testing.assert_array_equal(got.numpy(), np.asarray(want_ref))
    assert_quant_close(got.numpy(), want_pallas, *args)


@pytest.mark.parametrize("shape", [(24, 50), (7, 1)])
def test_stoch_quantize_ref_degenerate_rows(shape):
    """R = Δ = 0 rows: Δ is floored at 1e-12, c = 0, so the row passes
    q_prev through unchanged, as in the JAX reference."""
    n, d = shape
    args = quant_inputs(n, d, seed=3, degenerate_rows=(0, n - 1))
    got = ref.stoch_quantize_ref(*(torch.from_numpy(a) for a in args))
    want = jref.stoch_quantize_ref(*(jnp.asarray(a) for a in args))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy()[[0, n - 1]],
                                  args[1][[0, n - 1]])


@pytest.mark.parametrize("shape", MIX_SHAPES)
def test_bipartite_mix_ref_matches_jax_ref_and_pallas(shape):
    m, n, d = shape
    adj, vals = mix_inputs(m, n, d, seed=m + n + d)
    got = ref.bipartite_mix_ref(torch.from_numpy(adj), torch.from_numpy(vals))
    assert tuple(got.shape) == (m, d) and got.dtype == torch.float32
    assert_mix_close(got.numpy(), jref.bipartite_mix_ref(
        jnp.asarray(adj), jnp.asarray(vals)), adj, vals)
    assert_mix_close(got.numpy(), pallas_mix(
        jnp.asarray(adj), jnp.asarray(vals), interpret=True), adj, vals)


def quant_walk(n, d):
    """The CUDA stoch_quantize kernel's walk over N d elements on the grid
    ``stoch_quant.blocks`` gives: each thread takes the group of 4 at g,
    then g += stride; a group's row by integer division of its first
    index, carried across d; the last N d % 4 one by one. Returns the
    writes of each element and the row each was given."""
    from repro_torch.kernels import stoch_quant as SQ
    total = n * d
    stride = SQ.blocks(total) * SQ.THREADS
    groups = total // 4
    writes = np.zeros(total, np.int64)
    rows = np.full(total, -1, np.int64)
    g = np.arange(stride, dtype=np.int64)
    while (g < groups).any():
        first = 4 * g[g < groups]
        row = first // d
        e = first - row * d
        for k in range(4):
            wrap = e == d
            row, e = row + wrap, np.where(wrap, 0, e)
            np.add.at(writes, first + k, 1)
            rows[first + k] = row
            e = e + 1
        g = g + stride
    i = 4 * groups + np.arange(stride)
    i = i[i < total]
    np.add.at(writes, i, 1)
    rows[i] = i // d
    return writes, rows


@pytest.mark.parametrize("shape", [(7, 1), (24, 50), (5, 4099), (64, 2000),
                                   (70000, 3)])
def test_stoch_quantize_flat_geometry_covers_each_element_once(shape):
    from repro_torch.kernels import stoch_quant as SQ
    n, d = shape
    writes, rows = quant_walk(n, d)
    assert (writes == 1).all()
    np.testing.assert_array_equal(rows, np.arange(n * d) // d)
    nb = SQ.blocks(n * d)
    assert 1 <= nb <= SQ.MAX_BLOCKS
    if shape == (24, 50):
        assert nb == 2                 # not one per row
    if shape == (64, 2000):
        assert nb == 125


def test_stoch_quantize_grid_loops_past_one_wave():
    """Past one wave the grid stops growing and threads loop."""
    from repro_torch.kernels import stoch_quant as SQ
    assert SQ.blocks(4 * SQ.THREADS * SQ.MAX_BLOCKS * 3) == SQ.MAX_BLOCKS
    writes, rows = quant_walk(1, 4 * SQ.THREADS * SQ.MAX_BLOCKS * 5 + 3)
    assert (writes == 1).all() and (rows == 0).all()
