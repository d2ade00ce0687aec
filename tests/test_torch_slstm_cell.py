"""The port's plain sLSTM cell (B9's contract, ``kernels/ref.py``) against
the JAX package's oracle ``repro.kernels.ref.slstm_cell_ref`` and its
Pallas kernel ``repro.kernels.slstm_cell.slstm_cell`` in interpret mode,
and the port's sLSTM serving forward through ``ops.slstm_cell`` against
its time loop, on the CPU.

Tolerances, those of the JAX package's own kernel test
(``tests/test_kernels.py::test_slstm_cell_matches_ref``): ``hs`` to rtol
and atol 1e-5, the final state to rtol 1e-4 and atol 1e-5 (the stabilizer
``m`` and the sums ``c``, ``n`` grow with the sequence, and the two
frameworks sum ``h R`` in different orders). The model-level check is the
JAX package's ``test_slstm_model_kernel_path`` tolerance, rtol 1e-4 and
atol 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.slstm_cell import slstm_cell as jslstm_cell
from repro_torch import interop
from repro_torch.configs import base
from repro_torch.kernels import ops, ref
from repro_torch.models import xlstm
from test_torch_cuda import cell_inputs, cell_tensors

# (B, S, H, dh): B not a multiple of the TPU's 8-row block and S not a
# multiple of its 128-step chunk; one row, one head; a full 8-row block
SHAPES = [(3, 129, 2, 16), (1, 5, 1, 8), (8, 64, 4, 32)]


def _port(args, wx_dtype=torch.float32):
    return cell_tensors(args, "cpu", wx_dtype)


def assert_cell_close(got, want):
    hs, st = got
    np.testing.assert_allclose(np.asarray(hs), np.asarray(want[0]),
                               rtol=1e-5, atol=1e-5)
    for a, b in zip(st, want[1]):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-4,
                                   atol=1e-5)


@pytest.mark.parametrize("m0", ["fresh", "admitted", "carried"])
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_slstm_cell_matches_jax_oracle(shape, m0):
    args = cell_inputs(shape, m0, seed=sum(shape))
    want = jref.slstm_cell_ref(*map(jnp.asarray, args))
    assert_cell_close(ref.slstm_cell_ref(*_port(args)), want)


@pytest.mark.parametrize("m0", ["fresh", "admitted"])
@pytest.mark.parametrize("shape", [(3, 129, 2, 16), (8, 64, 4, 32)])
def test_plain_slstm_cell_matches_pallas_kernel(shape, m0):
    """The Pallas kernel at its own tiling (8-row blocks, 128-step chunks:
    the (3, 129) case pads rows and 127 steps)."""
    args = cell_inputs(shape, m0, seed=sum(shape) + 1)
    want = jslstm_cell(*map(jnp.asarray, args), interpret=True)
    assert_cell_close(ref.slstm_cell_ref(*_port(args)), want)


def test_plain_slstm_cell_reads_bf16_wx_as_the_jax_oracle():
    """bf16 projections (the xlstm-125m config's activations) are widened
    to float32 in the step, on both sides."""
    args = cell_inputs((3, 129, 2, 16), "fresh", 5, wx_dtype="bfloat16")
    jargs = list(map(jnp.asarray, args))
    jargs[0] = jargs[0].astype(jnp.bfloat16)
    want = jref.slstm_cell_ref(*jargs)
    assert_cell_close(ref.slstm_cell_ref(*_port(args, torch.bfloat16)), want)


def test_ops_slstm_cell_runs_the_plain_version_on_the_cpu():
    args = _port(cell_inputs((3, 17, 2, 16), "carried", 3))
    before = dict(ops.launches)
    got, want = ops.slstm_cell(*args), ref.slstm_cell_ref(*args)
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=0)
    for a, b in zip(got[1], want[1]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert ops.launches == before
    assert "slstm_cell" in ops.KERNELS


def test_ops_slstm_cell_raises_for_a_tensor_off_the_cpu():
    """Neither CPU nor CUDA: the kernel wrapper refuses it (no fall-back
    to the plain version)."""
    args = [torch.zeros(a.shape, device="meta")
            for a in cell_inputs((2, 3, 1, 8), "fresh", 0)]
    with pytest.raises(ValueError, match="CUDA"):
        ops.slstm_cell(*args)


def _smoke_slstm():
    """The smoke config's sLSTM cell, JAX init (seed 0) carried across."""
    from repro.configs import base as jbase
    from repro.models import xlstm as jxlstm

    jcfg = jbase.get_smoke_config("xlstm-125m")
    jp = jxlstm.slstm_init(jax.random.PRNGKey(0), jcfg)
    flat = {jax.tree_util.keystr(p): np.asarray(x)
            for p, x in jax.tree_util.tree_flatten_with_path(jp)[0]}
    return (base.get_smoke_config("xlstm-125m"),
            interop.tree_from_numpy(flat, device="cpu"))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_slstm_apply_kernel_route_equals_time_loop(dtype):
    """The serving forward with ``use_kernel=True`` (``ops.slstm_cell``)
    against ``use_kernel=False`` (the port's time loop), without a cache
    and from a cache (the final states too), as the JAX package's
    ``test_slstm_model_kernel_path`` holds its own."""
    cfg, p = _smoke_slstm()
    rng = np.random.default_rng(1)
    x = torch.from_numpy(
        (0.3 * rng.standard_normal((2, 40, cfg.d_model))).astype(
            np.float32)).to(dtype)
    a = xlstm.slstm_apply(p, cfg, x, use_kernel=True)
    b = xlstm.slstm_apply(p, cfg, x, use_kernel=False)
    np.testing.assert_allclose(a.float().numpy(), b.float().numpy(),
                               rtol=1e-4, atol=1e-5)
    caches = []
    for use_kernel in (True, False):
        cache = xlstm.slstm_cache(cfg, 2)
        xlstm.slstm_apply(p, cfg, x[:, :7], cache=cache, use_kernel=False)
        out = xlstm.slstm_apply(p, cfg, x[:, 7:], cache=cache,
                                use_kernel=use_kernel)
        caches.append((out, cache))
    (ka, kc), (la, lc) = caches
    np.testing.assert_allclose(ka.float().numpy(), la.float().numpy(),
                               rtol=1e-4, atol=1e-5)
    for name in ("c", "n", "m", "h"):
        np.testing.assert_allclose(kc[name].numpy(), lc[name].numpy(),
                                   rtol=1e-4, atol=1e-5, err_msg=name)


def test_slstm_apply_kernel_route_calls_ops_only_for_multi_token_forwards(
        monkeypatch):
    cfg, p = _smoke_slstm()
    calls = []
    real = ops.slstm_cell
    monkeypatch.setattr(ops, "slstm_cell",
                        lambda *a: calls.append(a[0].shape) or real(*a))
    cache = xlstm.slstm_cache(cfg, 3)
    x = torch.ones((3, 5, cfg.d_model))
    xlstm.slstm_apply(p, cfg, x, cache=cache, use_kernel=True)
    xlstm.slstm_apply(p, cfg, x[:, :1], cache=cache, use_kernel=True)
    xlstm.slstm_apply(p, cfg, x, cache=cache, use_kernel=False)
    assert calls == [(3, 5, 4, 4 * 64)]
