"""The split decode of the paged-attention kernel (``csrc/paged_attention.cu``,
both contracts: B8 online and B7 one-shot) modelled in PyTorch on the CPU,
its wrapper's pure helpers, and the lockstep engine's padding against the
JAX package.

The kernel splits each sequence's slots over blocks of ``split_rows``
slots; in a block each of 8 warps keeps an online softmax over its 8 rows
of every 64-row tile; the block merges its warps and the last split to
arrive merges the splits: ``M = max m_s``, ``out = sum e^(m_s - M) acc_s /
sum e^(m_s - M) l_s``. The two contracts differ only where ctx = 0: the
online one gives zeros, the one-shot one the uniform average of V over
every slot of the table (each slot's logit 0, every split live).
:func:`split_decode_model` repeats that arithmetic in float32 and must
equal ``ref.paged_attention_online_ref`` or ``ref.paged_attention_ref``
(the kernel's contracts) to 1e-6 of max|V| (the same float32 terms summed
in another order). The kernel itself is held to its plain versions on the
card (``test_torch_cuda.py``).

The lockstep test runs the port's ``LockstepEngine`` and the JAX
package's on a stream of several waves of mixed prompt lengths, with the
settings of ``test_lockstep_greedy_tokens_match_jax``: float32
activations; greedy tokens equal.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.launch import serve as jserve
from repro.models import registry as jregistry
from repro_torch import interop
from repro_torch.configs import base
from repro_torch.kernels import ops, paged_attention, ref
from repro_torch.launch import serve
from test_torch_cuda import paged_inputs

WARP_ROWS = paged_attention.TILE // paged_attention.WARPS


def _merge(states):
    """Merge (m, l, acc) partials: M = max m, weights e^(m - M)."""
    m = torch.stack([s[0] for s in states])
    M = m.amax(0)
    e = torch.exp(m - M)
    l = (e * torch.stack([s[1] for s in states])).sum(0)
    acc = (e[..., None] * torch.stack([s[2] for s in states])).sum(0)
    return M, l, acc


def split_decode_model(q, k_pages, v_pages, block_tables, ctx_lens, *,
                       split_rows, k_scale=None, v_scale=None,
                       kv_bits=32, oneshot=False):
    """The split kernel's arithmetic, float32: splits of ``split_rows``
    slots up to n_rows = ceil(ctx / ps)·ps (splits past it leave nothing),
    64-row tiles, 8 rows of each tile per warp with its own online softmax
    (probabilities past ctx masked to 0), the warps merged per split, the
    live splits merged per (sequence, KV head). Where ctx = 0: zeros
    (online), or (``oneshot``) every slot of the table with logit 0, so
    every split is live, every probability 1 and the merge divides the sum
    of V by P·ps."""
    bsz, heads, hd = q.shape
    num_pages, ps, num_kv, _ = k_pages.shape
    groups = heads // num_kv
    pps = block_tables.shape[1]
    scale = 1.0 / float(np.sqrt(np.float32(hd)))
    bt = torch.clamp(block_tables.to(torch.int64), 0, num_pages - 1)

    def slots(pool, scales):                 # (B, P·ps, KV, hd) float32
        if kv_bits == 32:
            x = pool[bt].to(torch.float32)
        else:
            x = ref.kv_page_dequantize(pool[bt], scales[bt],
                                       kv_bits=kv_bits, head_dim=hd)
        return x.reshape(bsz, pps * ps, num_kv, hd)

    keys, vals = slots(k_pages, k_scale), slots(v_pages, v_scale)
    qb = q.to(torch.float32).reshape(bsz, num_kv, groups, hd)
    out = torch.zeros((bsz, num_kv, groups, hd), dtype=torch.float32)
    splits = paged_attention.split_count(pps, ps, split_rows)
    for b in range(bsz):
        ctx = int(ctx_lens[b])
        uniform = oneshot and ctx <= 0
        n_rows = (pps * ps if uniform
                  else min(-(-ctx // ps) * ps, pps * ps) if ctx > 0 else 0)
        live = -(-n_rows // split_rows)
        assert live <= splits
        parts = []
        for s in range(live):
            lo, hi = s * split_rows, min((s + 1) * split_rows, n_rows)
            warps = []
            for w in range(paged_attention.WARPS):
                m = torch.full((num_kv, groups), -1e30)
                l = torch.zeros((num_kv, groups))
                acc = torch.zeros((num_kv, groups, hd))
                for t0 in range(lo, hi, paged_attention.TILE):
                    r0 = t0 + w * WARP_ROWS
                    r1 = min(r0 + WARP_ROWS, hi)
                    if r1 <= r0:
                        continue
                    idx = torch.arange(r0, r1)
                    if uniform:         # no K read, no q·K
                        logit = torch.zeros((num_kv, groups, r1 - r0))
                    else:
                        logit = torch.einsum("kgd,rkd->kgr", qb[b],
                                             keys[b, idx]) * scale
                    valid = (idx < ctx) | uniform
                    logit = torch.where(valid, logit, -1e30)
                    m_new = torch.maximum(m, logit.amax(-1))
                    alpha = torch.exp(m - m_new)
                    p = torch.where(valid, torch.exp(logit - m_new[..., None]),
                                    0.0)
                    l = alpha * l + p.sum(-1)
                    acc = (alpha[..., None] * acc
                           + torch.einsum("kgr,rkd->kgd", p, vals[b, idx]))
                    m = m_new
                warps.append((m, l, acc))
            parts.append(_merge(warps))
        if parts:
            _, l, acc = _merge(parts)
            out[b] = acc / l[..., None]
    return out.reshape(bsz, heads, hd)


# (H, KV, hd, ps, P): the smoke model's heads (G 4) and tinyllama's (G 8),
# 256 table slots each
HEADS = {"smoke": (8, 2, 32, 4, 64), "tinyllama": (32, 4, 64, 16, 16)}
POOLS = [(32, torch.float32), (32, torch.bfloat16), (8, None), (4, None)]


@pytest.mark.parametrize("split_rows", [64, 128])
@pytest.mark.parametrize("kv_bits,pool_dtype", POOLS)
@pytest.mark.parametrize("heads", sorted(HEADS))
@pytest.mark.parametrize("oneshot", [False, True])
def test_split_decode_model_equals_online_contract(oneshot, heads, kv_bits,
                                                   pool_dtype, split_rows):
    """Both contracts (online: zeros at ctx = 0; one-shot: the uniform
    average over the table there), at ctx 0, 1 (every later split wholly
    past ctx), one before, on and one past a split boundary, one short of
    the table and the full table; slots past ctx poisoned (-1 or ids past
    the pool)."""
    h, kv, hd, ps, pps = HEADS[heads]
    full = pps * ps
    ctx = [0, 1, split_rows - 1, split_rows, split_rows + 1, full - 1, full]
    kw, vmax = paged_inputs(len(ctx), h, kv, hd, ps, pps, kv_bits, seed=7,
                            pool_dtype=pool_dtype or torch.float32, ctx=ctx)
    args = [kw.pop(k) for k in ("q", "k_pages", "v_pages", "block_tables",
                                "ctx_lens")]
    assert int((args[3] < 0).sum()) > 0                  # poisoned slots
    got = split_decode_model(*args, split_rows=split_rows, oneshot=oneshot,
                             **kw)
    if oneshot:
        want = ref.paged_attention_ref(*args, **kw)
        assert bool(torch.isfinite(got).all())
    else:
        want = ref.paged_attention_online_ref(*args, **kw)
        assert torch.equal(got[0], torch.zeros_like(got[0]))
    err = float((got - want).abs().max())
    assert err <= 1e-6 * vmax, (err, vmax)


@pytest.mark.parametrize("pages", [16, 64, 190, 191, 256])
def test_online_wrapper_helpers(pages):
    """Split count from the table width alone, the workspace's shape, and
    shared memory that fits a block for every pool kind at the smoke and
    tinyllama heads and grows with the table only by the combine's (m, l)
    table, 64 bytes a split."""
    ps, rows = 16, paged_attention.SPLIT_ROWS
    assert rows % paged_attention.TILE == 0
    splits = paged_attention.split_count(pages, ps, rows)
    assert splits == -(-pages * ps // rows)
    assert (splits - 1) * rows < pages * ps <= splits * rows
    assert paged_attention.split_count(pages, ps, 64) == -(-pages * ps // 64)
    assert (paged_attention.online_workspace_shape(8, 4, splits, 8, 64)
            == (8, 4, splits, 8, 66))
    for hd in (32, 64):
        for row_bytes in (4 * hd, 2 * hd, hd, hd // 2):    # f32 .. 4-bit
            smem = paged_attention.online_smem_bytes(hd, row_bytes, splits)
            assert smem <= paged_attention.SMEM_PER_BLOCK
            assert (smem - paged_attention.online_smem_bytes(hd, row_bytes, 1)
                    == 64 * (splits - 1))
    # bf16 pools at tinyllama's heads: far below the one-shot kernel's
    # footprint at this table width once it passes the switch
    if ops.paged_attention_online_selected(32, 4, 64, pages, ps):
        assert (paged_attention.online_smem_bytes(64, 128, splits)
                < paged_attention.oneshot_smem_bytes(8, 64, pages, ps))


# ------------------------------------------------------------- lockstep --
LENS, NEW = (9, 17, 5, 13), 6


def _flat(tree):
    return {jax.tree_util.keystr(p): np.asarray(x)
            for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("arch,cache_dtype", [
    ("tinyllama-1.1b", torch.bfloat16), ("xlstm-125m", torch.float32)])
def test_lockstep_pads_to_the_stream_longest_as_jax(arch, cache_dtype):
    """Two waves of two (prompts 9, 17 then 5, 13): both packages pad every
    wave to 17 tokens and size each cache for 17 + NEW, so the second
    wave's greedy tokens agree too. The port's cache dtype is the JAX
    engine's (bf16 K/V for attention; recurrent state in float32)."""
    jcfg = jbase.get_smoke_config(arch).with_overrides(dtype="float32")
    cfg = base.get_smoke_config(arch).with_overrides(dtype="float32")
    jp = jregistry.init_params(jcfg, jax.random.PRNGKey(0))
    params = interop.model_params_from_numpy(_flat(jp), cfg, "cpu")
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, cfg.vocab_size, n).astype(np.int32)
               for n in LENS]
    want = jserve.LockstepEngine(jcfg, jp, batch=2).run(prompts, NEW)
    got = serve.LockstepEngine(cfg, params, batch=2, device="cpu",
                               cache_dtype=cache_dtype).run(prompts, NEW)
    assert got["decode_steps"] == want["decode_steps"] == 2 * NEW
    for i in range(len(prompts)):
        assert got["outputs"][i].tolist() == want["outputs"][i].tolist(), i
    # a wave padded to its own longest (13) is another function: the
    # second wave's tokens differ from the padded run's
    alone = serve.LockstepEngine(cfg, params, batch=2, device="cpu",
                                 cache_dtype=cache_dtype).run(prompts[2:],
                                                              NEW)
    assert any(alone["outputs"][j].tolist() != got["outputs"][2 + j].tolist()
               for j in range(2))
