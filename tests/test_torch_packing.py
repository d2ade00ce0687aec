"""The port's packing and group-spec grammar against the JAX package's:
exact equality of the packed layout (leaf order, keystr paths, offsets,
column runs, group ids) on the xlstm-125m and xlstm-smoke parameter trees
and a toy tree, of ``resolve_groups`` for every spec form, of
``greedy_range_grouping`` and of ``remap_group_state``; and pack /
unpack / segment reductions on numpy-seeded values."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.core import engine as JE
from repro.core import packing as JP
from repro.models import registry as jregistry
from repro_torch.configs import base
from repro_torch.core import engine as E
from repro_torch.core import packing as P
from repro_torch.core import tree as T
from repro_torch.models import registry


def trees(name):
    """(JAX abstract tree, port meta tree) of one xlstm config."""
    if name == "toy":
        shapes = {"b": {"z": (3, 4), "a": (3, 2, 5)}, "a": (3, 7),
                  "c": {"mlp": {"w": (3, 1)}, "norm": {"scale": (3, 6)}},
                  "empty": {}}
        jt = jax.tree_util.tree_map(
            lambda s: jax.ShapeDtypeStruct(s, jnp.float32), shapes,
            is_leaf=lambda x: isinstance(x, tuple))
        pt = T.tree_map(lambda s: torch.empty(s, device="meta"),
                        _as_leaves(shapes))
        return jt, pt
    jcfg = (jbase.get_config if name == "xlstm-125m"
            else jbase.get_smoke_config)("xlstm-125m")
    cfg = (base.get_config if name == "xlstm-125m"
           else base.get_smoke_config)("xlstm-125m")
    jt = jax.eval_shape(lambda: jregistry.init_params(
        jcfg, jax.random.PRNGKey(0)))
    return jt, registry.init_params(cfg, device="meta")


class _Shape(tuple):
    pass


def _as_leaves(shapes):
    if isinstance(shapes, dict):
        return {k: _as_leaves(v) for k, v in shapes.items()}
    return _Shape(shapes)


TREES = ["toy", "xlstm-smoke", "xlstm-125m"]
SPECS = ["model", "leaf", "auto:1", "auto:3", "auto:99",
         "block:embed,mlp,norm", "block:norm,rest", "block:mlp,embed,rest",
         "block:cell"]


@pytest.fixture(scope="module", params=TREES)
def pair(request):
    return request.param, *trees(request.param)


def test_leaf_order_and_paths_match_jax(pair):
    name, jt, pt = pair
    jflat = jax.tree_util.tree_flatten_with_path(jt)[0]
    assert T.paths(pt) == tuple(jax.tree_util.keystr(p) for p, _ in jflat)
    assert [tuple(x.shape) for x in T.leaves(pt)] == [
        tuple(x.shape) for _, x in jflat]
    assert P.leaf_paths(pt) == JP.leaf_paths(jt)
    assert P.tree_bucket_names(pt) == JP.tree_bucket_names(jt)
    if name == "xlstm-125m":
        assert len(jflat) == 19
        assert registry.count_params(base.get_config("xlstm-125m")) \
            == jregistry.count_params(jbase.get_config("xlstm-125m")) \
            == 134_277_912
        assert registry.param_buckets(base.get_config("xlstm-125m")) \
            == jregistry.param_buckets(jbase.get_config("xlstm-125m"))


@pytest.mark.parametrize("spec", SPECS + [((0, 1), (2, 3)), (0, 1, 0, 1)],
                         ids=str)
def test_resolve_groups_and_layout_match_jax(pair, spec):
    name, jt, pt = pair
    n_leaves = len(T.leaves(pt))
    if isinstance(spec, tuple):          # pad the spec to this tree's leaves
        if isinstance(spec[0], tuple):
            spec = spec[:-1] + (tuple(range(2, n_leaves)),)
        else:
            spec = tuple(i % 2 for i in range(n_leaves))
    try:
        want = JE.resolve_groups(jt, spec)
    except JP.GroupSpecError as e:
        with pytest.raises(P.GroupSpecError):
            E.resolve_groups(pt, spec)
        assert "bucket" in str(e)
        return
    got = E.resolve_groups(pt, spec)
    assert got == want
    assert E.group_dims(pt, got) == JE.group_dims(jt, want)
    pk, jpk = P.make_packing(pt, got), JP.make_packing(jt, want)
    for field in ("shapes", "dims", "offsets", "group_ids", "n_groups",
                  "group_dims", "group_runs", "dim", "sorted_ids"):
        assert getattr(pk, field) == getattr(jpk, field), field
    if name != "xlstm-125m":             # (the full map is 134M entries)
        np.testing.assert_array_equal(pk.col_group_ids, jpk.col_group_ids)
        np.testing.assert_array_equal(
            P.runs_to_col_ids(pk.group_runs, pk.dim), jpk.col_group_ids)


@pytest.mark.parametrize("spec", ["block:", "block:a,,b", "block:mlp,mlp",
                                  "auto:0", "auto:x", "layers", "block:attn",
                                  "block:nosuchname", ((0,), (0, 1)),
                                  ((0,),), (0, (1,)), (0, 2)], ids=str)
def test_malformed_specs_raise_as_in_jax(spec):
    jt, pt = trees("toy")
    with pytest.raises(JP.GroupSpecError):
        JE.resolve_groups(jt, spec)
    with pytest.raises(P.GroupSpecError):
        E.resolve_groups(pt, spec)


@pytest.mark.parametrize("k", [1, 2, 3, 5, 8])
def test_greedy_range_grouping_matches_jax(k):
    rng = np.random.default_rng(k)
    for _ in range(5):
        n = int(rng.integers(1, 12))
        lr = rng.normal(size=n) * 3.0
        dims = rng.integers(1, 1000, size=n)
        assert P.greedy_range_grouping(lr, dims, k) == \
            JP.greedy_range_grouping(lr, dims, k)


@pytest.mark.parametrize("old,new", [((0, 1, 2, 3), (0, 0, 1, 1)),
                                     ((0, 0, 1, 1), (0, 1, 2, 3)),
                                     ((0, 1, 1, 2), (0, 0, 0, 1)),
                                     ((0, 1, 2, 3), (0, 1, 2, 3))])
def test_remap_group_state_matches_jax(old, new):
    rng = np.random.default_rng(3)
    n, g = 5, max(old) + 1
    side = {f: rng.uniform(size=(n, g)).astype(np.float32) for f in
            ("range_prev", "bits_prev", "delta_prev")}
    side["initialized"] = (rng.uniform(size=(n, g)) < 0.5).astype(np.float32)
    q = np.zeros((n, 4), np.float32)
    want = JE.remap_group_state(JE.GroupQuantState(
        q_hat=jnp.asarray(q), **{k: jnp.asarray(v) for k, v in side.items()}),
        old, new)
    got = E.remap_group_state(E.GroupQuantState(
        q_hat=torch.from_numpy(q),
        **{k: torch.from_numpy(v) for k, v in side.items()}), old, new)
    for f in side:
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)))


def _values(seed):
    """Numpy-seeded (N=3) values of the toy tree (empty dict included),
    for both packages."""
    jt, pt = trees("toy")
    rng = np.random.default_rng(seed)
    vals = [rng.standard_normal(x.shape).astype(np.float32)
            for x in jax.tree_util.tree_leaves(jt)]
    jtree = jax.tree_util.tree_unflatten(jax.tree_util.tree_structure(jt),
                                         [jnp.asarray(v) for v in vals])
    return jtree, T.unflatten(pt, [torch.from_numpy(v.copy()) for v in vals])


@pytest.mark.parametrize("spec", ["model", "leaf", "block:mlp,norm"])
def test_pack_unpack_and_segment_reductions_match_jax(spec):
    jtree, ptree = _values(11)
    ids = E.resolve_groups(ptree, spec)
    pk, jpk = P.make_packing(ptree, ids), JP.make_packing(jtree, ids)
    buf = P.pack(pk, ptree)
    np.testing.assert_array_equal(buf.numpy(), np.asarray(JP.pack(jpk, jtree)))
    back = P.unpack(pk, buf)
    for a, b in zip(T.leaves(back), T.leaves(ptree)):
        assert torch.equal(a, b)
    assert set(back) == set(ptree) and back["empty"] == {}
    np.testing.assert_array_equal(P.segment_maxabs(pk, buf).numpy(),
                                  np.asarray(JP.segment_maxabs(
                                      jpk, JP.pack(jpk, jtree))))
    np.testing.assert_allclose(P.segment_sqnorm(pk, buf).numpy(),
                               np.asarray(JP.segment_sqnorm(
                                   jpk, JP.pack(jpk, jtree))), rtol=1e-6)


def test_leaf_log_ranges_and_auto_grouper_match_jax():
    jtheta, ptheta = _values(1)
    jq, pq = _values(2)
    np.testing.assert_allclose(E.leaf_log_ranges(ptheta, pq),
                               JE.leaf_log_ranges(jtheta, jq), rtol=1e-12)
    cfg = E.EngineConfig(groups="auto:2", regroup_every=3)
    jcfg = JE.EngineConfig(groups="auto:2", regroup_every=3)
    ag, jag = E.AutoGrouper.from_config(cfg), JE.AutoGrouper.from_config(jcfg)
    assert [ag.should_regroup(i) for i in range(7)] == [
        jag.should_regroup(i) for i in range(7)]
    for _ in range(2):
        assert ag.regroup(ptheta, pq) == jag.regroup(jtheta, jq)
