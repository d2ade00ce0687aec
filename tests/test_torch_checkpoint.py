"""Checkpoints: the port writes and reads the JAX package's npz layout
(leaves under their keystr paths plus a JSON manifest), so a checkpoint of
either package restores in the other, bit for bit."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import npz as jckpt
from repro.configs import base as jbase
from repro.models import registry as jregistry
from repro_torch import interop
from repro_torch.checkpoint import npz as ckpt
from repro_torch.core import tree as T


@pytest.fixture(scope="module")
def trees():
    """A worker-stacked xlstm-smoke parameter tree (N=2) with numpy-seeded
    values, as a JAX tree and as the port's."""
    jcfg = jbase.get_smoke_config("xlstm-125m")
    abstract = jax.eval_shape(lambda: jregistry.init_params(
        jcfg, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(0)
    flat = {jax.tree_util.keystr(p): rng.standard_normal(
        (2,) + x.shape).astype(np.float32)
        for p, x in jax.tree_util.tree_flatten_with_path(abstract)[0]}
    jtree = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(abstract),
        [jnp.asarray(v) for v in flat.values()])
    return jtree, interop.tree_from_numpy(flat, device="cpu"), flat


def test_jax_checkpoint_restores_in_the_port(tmp_path, trees):
    jtree, ptree, flat = trees
    jckpt.save(tmp_path, 7, jtree)
    template = T.tree_map(torch.zeros_like, ptree)
    got, step = ckpt.restore(tmp_path, template)
    assert step == 7
    for path, leaf in T.to_paths(got).items():
        np.testing.assert_array_equal(leaf.numpy(), flat[path])


def test_port_checkpoint_restores_in_jax(tmp_path, trees):
    jtree, ptree, flat = trees
    ckpt.save(tmp_path, 3, ptree)
    manifest = json.loads((tmp_path / "step_3.json").read_text())
    assert list(manifest) == list(flat)
    template = jax.tree_util.tree_map(jnp.zeros_like, jtree)
    got, step = jckpt.restore(tmp_path, template)
    assert step == 3
    for p, leaf in jax.tree_util.tree_flatten_with_path(got)[0]:
        np.testing.assert_array_equal(np.asarray(leaf),
                                      flat[jax.tree_util.keystr(p)])


def test_port_checkpoint_keeps_the_newest_and_checks_shapes(tmp_path, trees):
    _, ptree, _ = trees
    for step in (1, 2, 3, 4):
        ckpt.save(tmp_path, step, ptree, keep=2)
    assert sorted(ckpt.all_steps(tmp_path)) == [3, 4]
    assert ckpt.latest_step(tmp_path) == 4
    bad = dict(ptree, final_norm={"scale": torch.zeros((2, 5))})
    with pytest.raises(ValueError, match="shape"):
        ckpt.restore(tmp_path, bad)
    with pytest.raises(FileNotFoundError):
        ckpt.restore(tmp_path / "none", ptree)
