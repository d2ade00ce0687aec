"""The port's plain sLSTM cell (B9's contract, ``kernels/ref.py``) against
the JAX package's oracle ``repro.kernels.ref.slstm_cell_ref`` and its
Pallas kernel ``repro.kernels.slstm_cell.slstm_cell`` in interpret mode,
the port's sLSTM serving forward through ``ops.slstm_cell`` against its
time loop, and a float32 model of the CUDA kernel's cluster partition
(``csrc/slstm_cell.cu``), on the CPU.

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
from repro_torch.kernels import ops, ref, slstm_cell
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


# --------------------------------------------- the kernel's partition --
def cluster_model(wx, r_w, fbias, c0, n0, m0, h0):
    """B9's arithmetic in float32 numpy, as ``csrc/slstm_cell.cu``
    partitions it (every (head, row tile) alike, so all run together here;
    the tile size does not change a row's arithmetic): a cluster of
    ``slstm_cell.cluster_size(dh)`` CTAs, CTA r owning the units [r·U,
    (r+1)·U), U = ceil(dh / C), and their four gate columns of R. A unit's
    product is split over 16 k slices, slice s taking k = 64 j + 4 s + e in
    that order (h and R padded with zeros to 64 ceil(dh / 64)), and the
    slices' sums are reduced as the kernel's shuffles add them: s + (s ^ 8),
    then ^ 4, ^ 2, ^ 1. Each CTA reads h from its own double-buffered copy,
    buf[t % 2], and writes its units' new h into buf[(t + 1) % 2] of every
    CTA."""
    f32 = np.float32
    b, s, heads, dh4 = wx.shape
    dh = dh4 // 4
    n_cta = slstm_cell.cluster_size(dh)
    units = -(-dh // n_cta)
    hp = 64 * -(-dh // 64)
    r_pad = np.zeros((heads, hp, dh4), f32)
    r_pad[:, :dh] = r_w
    # (16 slices, 4 ceil(dh / 64)) k indices, in each slice's order
    order = np.array([[64 * j + 4 * sl + e for j in range(hp // 64)
                       for e in range(4)] for sl in range(16)])
    ctas = []                          # per CTA: its units, columns, R
    for rank in range(n_cta):
        own = np.arange(rank * units, min((rank + 1) * units, dh))
        cols = np.concatenate([g * dh + own for g in range(4)])
        ctas.append((own, cols, r_pad[:, order][..., cols]))
    buf = np.zeros((n_cta, 2, b, heads, hp), f32)      # each CTA's copies
    buf[:, 0, ..., :dh] = h0
    c, n, m = (x.astype(f32).copy() for x in (c0, n0, m0))
    hs = np.zeros((b, s, heads, dh), f32)
    for t in range(s):
        for rank, (own, cols, rk) in enumerate(ctas):
            hk = buf[rank, t % 2][..., order]          # (B, H, 16, KJ·4)
            part = np.zeros((b, heads, 16, len(cols)), f32)
            for j in range(order.shape[1]):            # (H, 16, cols)
                part = part + hk[..., j, None] * rk[:, :, j]
            for w in (8, 4, 2, 1):
                part = part[:, :, :w] + part[:, :, w:2 * w]
            pre = wx[:, t][..., cols].astype(f32) + part[:, :, 0]
            i_pre, f_pre, z_pre, o_pre = np.split(pre, 4, axis=-1)
            fx = f_pre + fbias[:, own]
            log_f = np.minimum(fx, f32(0)) - np.log1p(np.exp(-np.abs(fx)))
            m_new = np.maximum(log_f + m[..., own], i_pre)
            i_sc = np.exp(i_pre - m_new)
            f_sc = np.exp(log_f + m[..., own] - m_new)
            c[..., own] = f_sc * c[..., own] + i_sc * np.tanh(z_pre)
            n[..., own] = np.maximum(f_sc * n[..., own] + i_sc, f32(1e-6))
            h = f32(1) / (f32(1) + np.exp(-o_pre)) * c[..., own] / n[..., own]
            m[..., own] = m_new
            hs[:, t][..., own] = h
            buf[:, (t + 1) % 2][..., own] = h[None]     # every copy
        assert all(np.array_equal(buf[0, (t + 1) % 2], buf[r, (t + 1) % 2])
                   for r in range(n_cta))
    return hs, (c, n, m, buf[0, s % 2][..., :dh])


@pytest.mark.parametrize("m0", ["fresh", "admitted", "carried"])
@pytest.mark.parametrize("shape", [(3, 129, 2, 16), (1, 64, 4, 192),
                                   (2, 9, 1, 256)])
def test_cluster_model_matches_plain_cell_and_jax_oracle(shape, m0):
    """The kernel's partition (4 CTAs at dh 192, 8 at 256, 1 at 16) against
    the port's plain cell and the JAX oracle, at the JAX kernel test's
    tolerances."""
    args = cell_inputs(shape, m0, seed=sum(shape) + 7)
    got = cluster_model(*args)
    assert got[0].dtype == np.float32
    assert_cell_close(got, ref.slstm_cell_ref(*_port(args)))
    assert_cell_close(got, jref.slstm_cell_ref(*map(jnp.asarray, args)))


@pytest.mark.parametrize("dh,want", [(8, 1), (16, 1), (64, 1), (65, 2),
                                     (128, 2), (129, 4), (192, 4),
                                     (193, 8), (256, 8)])
def test_cluster_size_follows_head_width(dh, want):
    """C CTAs per cluster: each owns ceil(dh / C) <= 64 units (16 threads
    each, at most 1024), and R's slice of one CTA, dh x 4dh float32 / C,
    fits the 232,448 bytes a Hopper block may use."""
    c = slstm_cell.cluster_size(dh)
    assert c == want
    assert -(-dh // c) <= 64
    assert 4 * dh * 4 * dh / c <= slstm_cell.SMEM_PER_BLOCK


def test_cluster_size_covers_every_head_width_and_refuses_wider():
    for dh in range(1, slstm_cell.MAX_HEAD_DIM + 1):
        c = slstm_cell.cluster_size(dh)
        assert c in (1, 2, 4, 8)
        assert 16 * dh * dh <= c * slstm_cell.SMEM_PER_BLOCK
        units = -(-dh // c)
        assert 32 * -(-units // 2) <= 1024
    with pytest.raises(ValueError, match="head width"):
        slstm_cell.cluster_size(slstm_cell.MAX_HEAD_DIM + 1)


@pytest.mark.parametrize("batch,heads,max_clusters,want", [
    (1, 4, 33, 1), (8, 4, 32, 1), (8, 4, 31, 2), (8, 4, 8, 4),
    (8, 4, 4, 8), (64, 4, 16, 8), (3, 2, 2, 4)])
def test_rows_per_cluster_fills_one_wave(batch, heads, max_clusters, want):
    """The fewest rows per cluster whose clusters all run at once; all 8
    where no choice fits."""
    assert slstm_cell.rows_per_cluster(batch, heads, max_clusters) == want
