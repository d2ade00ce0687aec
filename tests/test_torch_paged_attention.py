"""The port's paged-attention plain versions and KV page codec against the
JAX package, on the CPU (numpy-seeded inputs at the smoke model's heads
and at tinyllama's heads with a short table).

Tolerances and their reasons:

* ``kv_page_quantize`` codes and ranges, and the dequantized pages: bit
  for bit (the same float32 operations in the same order, the Eq. (18)
  schedule reproduced exactly by ``core.quantization``).
* ``paged_attention_ref`` against ``repro.kernels.ref.paged_attention_ref``
  and against the JAX kernels in interpret mode: 1e-6 of max|V| (the dots
  and V sums of the two frameworks add in different orders; the Pallas
  interpret path may also contract a multiply-add).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import paged_attention as jpaged
from repro.kernels import ref as jref
from repro_torch.kernels import ops, paged_attention, ref
from test_torch_cuda import PAGED_SHAPES, paged_call, paged_inputs

# (B, H, KV, hd, ps, P): the smoke model's heads, tinyllama's with 4 pages,
# and the wider head dims of the served configs at their query heads per
# KV head (h2o-danube 80, zamba2 112, mistral-large 128, gemma3 256)
CPU_SHAPES = {"smoke": PAGED_SHAPES["smoke"],
              "tinyllama-heads": (2, 32, 4, 64, 16, 4),
              "hd80": (2, 8, 2, 80, 4, 4), "hd112": (2, 2, 2, 112, 4, 4),
              "hd128": (2, 12, 1, 128, 4, 4), "hd256": (2, 4, 2, 256, 4, 4)}
CASES = [(s, b) for s in sorted(CPU_SHAPES) for b in (32, 8, 4)]


def _jax_kw(kw):
    out = {k: jnp.asarray(v.numpy()) for k, v in kw.items()
           if isinstance(v, torch.Tensor)}
    out["kv_bits"] = kw["kv_bits"]
    return out


def _jax_call(fn, kw, **extra):
    j = _jax_kw(kw)
    return np.asarray(fn(j.pop("q"), j.pop("k_pages"), j.pop("v_pages"),
                         j.pop("block_tables"), j.pop("ctx_lens"), **j,
                         **extra))


@pytest.mark.parametrize("kv_bits", [8, 4])
def test_kv_page_quantize_matches_jax_bitwise(kv_bits):
    rng = np.random.default_rng(kv_bits)
    x = (rng.standard_normal((6, 4, 2, 64))
         * rng.uniform(1e-3, 30.0, size=(6, 4, 2, 1))).astype(np.float32)
    x[0, 0, 0] = 0.0                                    # a zero range
    x[1, 1, 1, :3] = (1.0, -1.0, 0.5)
    jc, jr = jref.kv_page_quantize(jnp.asarray(x), kv_bits=kv_bits)
    c, r = ref.kv_page_quantize(torch.from_numpy(x), kv_bits=kv_bits)
    np.testing.assert_array_equal(c.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(r.numpy(), np.asarray(jr))
    jd = jref.kv_page_dequantize(jc, jr, kv_bits=kv_bits, head_dim=64)
    d = ref.kv_page_dequantize(c, r, kv_bits=kv_bits, head_dim=64)
    np.testing.assert_array_equal(d.numpy(), np.asarray(jd))


def test_kv_page_quantize_rejects_bad_widths():
    with pytest.raises(ValueError, match="kv_bits"):
        ref.kv_page_quantize(torch.zeros(2, 4), kv_bits=16)
    with pytest.raises(ValueError, match="even"):
        ref.kv_page_quantize(torch.zeros(2, 5), kv_bits=4)


@pytest.mark.parametrize("shape,kv_bits", CASES)
def test_paged_attention_ref_matches_jax(shape, kv_bits):
    kw, vmax = paged_inputs(*CPU_SHAPES[shape], kv_bits, seed=21)
    got = paged_call(ref.paged_attention_ref, kw, "cpu").numpy()
    want = _jax_call(jref.paged_attention_ref, kw)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * vmax)
    kern = _jax_call(jpaged.paged_attention_decode, kw, interpret=True)
    np.testing.assert_allclose(got, kern, rtol=0, atol=1e-6 * vmax)
    # ctx = 0 (sequence 0): the uniform average over every slot of the
    # clamped table, as the JAX one-shot kernel gives
    assert np.abs(got[0]).max() > 0


@pytest.mark.parametrize("shape,kv_bits", CASES)
def test_online_plain_version_matches_jax_online_kernel(shape, kv_bits):
    kw, vmax = paged_inputs(*CPU_SHAPES[shape], kv_bits, seed=22)
    got = paged_call(ref.paged_attention_online_ref, kw, "cpu").numpy()
    kern = _jax_call(jpaged.paged_attention_decode_online, kw,
                     interpret=True)
    np.testing.assert_allclose(got, kern, rtol=0, atol=1e-6 * vmax)
    np.testing.assert_array_equal(got[0], 0.0)             # ctx = 0


def test_ops_clamps_poisoned_tables_and_counts_nothing_on_cpu(monkeypatch):
    monkeypatch.delenv("REPRO_PAGED_ATTN_ONLINE", raising=False)
    kw, _ = paged_inputs(*CPU_SHAPES["smoke"], 8, seed=23)
    num_pages = kw["k_pages"].shape[0]
    clamped = dict(kw, block_tables=torch.clamp(kw["block_tables"], 0,
                                                num_pages - 1))
    before = dict(ops.launches)
    got = paged_call(ops.paged_attention_decode, kw, "cpu")
    want = paged_call(ref.paged_attention_ref, clamped, "cpu")
    assert torch.equal(got, want)
    assert ops.launches == before


def test_variant_threshold_is_the_one_shot_shared_memory():
    """tinyllama (G = 8, hd = 64, ps = 16): the one-shot kernel up to 190
    pages per sequence, the online one from 191; the limit is half of what
    a Hopper block may use."""
    assert ops.ONESHOT_SMEM_LIMIT == paged_attention.SMEM_PER_BLOCK // 2
    pick = ops.paged_attention_online_selected
    assert not pick(32, 4, 64, 64, 16)
    assert not pick(32, 4, 64, 190, 16)
    assert pick(32, 4, 64, 191, 16)
    assert pick(32, 4, 64, 256, 16)
    assert (paged_attention.oneshot_smem_bytes(8, 64, 190, 16)
            <= ops.ONESHOT_SMEM_LIMIT
            < paged_attention.oneshot_smem_bytes(8, 64, 191, 16))
    assert (paged_attention.online_smem_bytes(              # bf16 pools
        64, 2 * 64,
        paged_attention.split_count(256, 16, paged_attention.SPLIT_ROWS))
            < ops.ONESHOT_SMEM_LIMIT)


@pytest.mark.parametrize("heads,num_kv,hd,first_online", [
    (32, 8, 80, 369), (32, 32, 112, 1358), (96, 8, 128, 101),
    (8, 4, 256, 379)])
def test_variant_switch_point_at_the_wider_head_dims(heads, num_kv, hd,
                                                     first_online):
    """The one-shot/online switch keeps its rule at every head dim: at
    h2o-danube's (G 4, hd 80), zamba2's (G 1, 112), mistral-large's (G 12,
    128) and gemma3's global layers (G 2, 256), 16-slot pages, the first
    table width (pages) that takes the online contract."""
    pick = ops.paged_attention_online_selected
    assert not pick(heads, num_kv, hd, first_online - 1, 16)
    assert pick(heads, num_kv, hd, first_online, 16)


def test_variant_override_and_cpu_online_contract(monkeypatch):
    """``REPRO_PAGED_ATTN_ONLINE`` forces the variant as in the JAX
    package; on the CPU the online choice runs its plain version (zeros
    where ctx = 0)."""
    kw, _ = paged_inputs(*CPU_SHAPES["smoke"], 32, seed=24)
    monkeypatch.setenv("REPRO_PAGED_ATTN_ONLINE", "1")
    assert ops.paged_attention_online_selected(8, 2, 32, 16, 4)
    online = paged_call(ops.paged_attention_decode, kw, "cpu")
    assert torch.equal(online[0], torch.zeros_like(online[0]))
    monkeypatch.setenv("REPRO_PAGED_ATTN_ONLINE", "0")
    assert not ops.paged_attention_online_selected(32, 4, 64, 4096, 16)
    oneshot = paged_call(ops.paged_attention_decode, kw, "cpu")
    assert torch.equal(online[1:], oneshot[1:])


def test_cuda_wrapper_refuses_cpu_tensors():
    kw, _ = paged_inputs(*CPU_SHAPES["smoke"], 32, seed=25)
    with pytest.raises(ValueError, match="CUDA"):
        paged_call(lambda *a, **k: paged_attention.paged_attention_cuda(
            *a, online=False, **k), kw, "cpu")
