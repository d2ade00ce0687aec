"""``launch.train.campaign_lm_run`` (lm-sweep's stage function) on the CPU
at a tiny size: tinyllama-smoke, 2 workers, batch 2, seq 8, 3-4 steps.

* Against the JAX package's ``campaign_lm_run`` from the same initial
  parameters (the JAX init, carried across), float32 activations in both
  (``get_smoke_config`` is patched in both packages, as
  ``test_torch_attn_consensus.py`` overrides the dtype): unquantized, the
  loss history within rel 1e-4 and the per-step bits equal; quantized with
  the JAX draws injected, the per-step bits equal at steps 0 and 1 and the
  loss within 1e-3 at every step (that file's tolerances and reasons).
  The per-step bits are read from each run's last in-flight checkpoint.
* A run killed after a mid-run checkpoint (a ``KeyboardInterrupt`` raised
  by the checkpoint, as the self-test's ``die_marker`` does) and resumed
  with ``resume=True`` equals an uninterrupted run bit for bit (loss
  history, total bits and the final engine state), the completed run is
  skipped, and the quantized baseline's section is what ``compare_with``
  reads; ``only=`` runs the dependency first; a missing section is fatal.
* The trainer's flags: ``--campaign-only``, ``--resume``.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.campaign.runner import RunContext as JRunContext
from repro.configs import base as jbase
from repro.launch import train as jtrain
from repro.models import registry as jregistry
from repro_torch import interop
from repro_torch.campaign import runner as prunner
from repro_torch.campaign.runner import RunContext, Runner
from repro_torch.campaign.spec import Campaign, Stage, stage
from repro_torch.campaign.store import ResultStore
from repro_torch.checkpoint import npz
from repro_torch.configs import base
from repro_torch.core import tree as T
from repro_torch.launch import train

ARCH = "tinyllama-1.1b"
N = 2
TINY = dict(workers=N, batch=2, seq=8, steps=3, local_steps=2, arch=ARCH)
FN = "repro_torch.launch.train:campaign_lm_run"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def float32_smoke(monkeypatch):
    """Both packages' ``get_smoke_config`` with float32 activations."""
    for mod in (base, jbase):
        orig = mod.get_smoke_config
        monkeypatch.setattr(
            mod, "get_smoke_config",
            lambda name, orig=orig: orig(name).with_overrides(
                dtype="float32"))


def jax_step_draws(dim):
    """The JAX step's packed (N, D) uniforms: per step i the key
    PRNGKey(1000 + i), split into one key per phase."""
    def uniforms(i, phase):
        k = jax.random.split(jax.random.PRNGKey(1000 + i))[phase]
        return torch.from_numpy(np.array(
            jax.random.uniform(k, (N, dim), jnp.float32)))
    return uniforms


def last_bits(run_dir):
    ckpt = run_dir / "ckpt"
    step = max(int(p.stem.split("_")[1]) for p in ckpt.glob("step_*.json"))
    with np.load(ckpt / f"step_{step}.npz") as data:
        return data["['bits']"]


def run_pair(tmp_path, quantize):
    section = ["lm", "q" if quantize else "u"]
    jctx = JRunContext(None, tmp_path / "jax", None)
    want = jtrain.campaign_lm_run(section, quantize=quantize, ctx=jctx,
                                  **TINY)
    jcfg = jbase.get_smoke_config(ARCH)
    one = jregistry.init_params(jcfg, jax.random.PRNGKey(0))
    params = interop.tree_from_numpy(
        {jax.tree_util.keystr(p): np.asarray(x) for p, x in
         jax.tree_util.tree_flatten_with_path(one)[0]}, device="cpu")
    dim = sum(x.numel() for x in T.leaves(params))
    ctx = RunContext(None, tmp_path / "port", None, device="cpu")
    got = train.campaign_lm_run(
        section, quantize=quantize, ctx=ctx, params=params,
        uniforms=jax_step_draws(dim) if quantize else None, **TINY)
    return (got, last_bits(tmp_path / "port"), want,
            last_bits(tmp_path / "jax"))


@pytest.mark.parametrize("quantize", [False, True])
def test_campaign_lm_run_matches_the_jax_package(tmp_path, float32_smoke,
                                                 quantize):
    got, bits, want, jbits = run_pair(tmp_path, quantize)
    assert got.section == want.section
    assert got.claims_path == want.claims_path == ("lm_sweep", "claims")
    assert [c.name for c in got.claims] == [c.name for c in want.claims]
    assert sorted(got.data) == sorted(want.data)
    for k in ("arch", "workers", "steps", "quantize", "groups",
              "censor_mode", "mix_backend", "resumed_from"):
        assert got.data[k] == want.data[k], k
    assert got.data["arch"] == "tinyllama-smoke"
    loss, jloss = got.data["loss_history"], want.data["loss_history"]
    assert np.isfinite(loss).all() and len(loss) == 3
    if quantize:
        np.testing.assert_array_equal(bits[:2], jbits[:2])
        np.testing.assert_allclose(loss, jloss, atol=1e-3)
    else:
        np.testing.assert_array_equal(bits, jbits)
        np.testing.assert_allclose(loss, jloss, rtol=1e-4)
    assert got.data["total_bits"] == float(np.nansum(bits))


# --------------------------------------------------------- kill / resume --
def lm_campaign(steps=4, ckpt_every=2):
    common = dict(TINY, steps=steps, local_steps=1, ckpt_every=ckpt_every)
    return Campaign(name="lm-tiny", stages=(
        stage("base", FN, configs=[
            dict(common, section=["lm", "q"]),
            dict(common, quantize=False, section=["lm", "u"],
                 compare_with=["lm", "q"])], names=["q", "u"]),
        stage("grid", FN, deps=["base"], configs=[
            dict(common, steps=2, groups="leaf", mix_backend="sparse",
                 section=["lm", "g"])], names=["g"]),
    ))


def kill_at(monkeypatch, run_name, at_step):
    """The first checkpoint of run ``run_name`` at ``at_step`` is written,
    then the process is 'killed'; later runs are not touched."""
    orig = prunner.RunContext.checkpoint
    fired = []

    def checkpoint(self, step, tree, keep=2):
        path = orig(self, step, tree, keep)
        if self.spec.name == run_name and step == at_step and not fired:
            fired.append(step)
            raise KeyboardInterrupt(f"killed after step {step}")
        return path
    monkeypatch.setattr(prunner.RunContext, "checkpoint", checkpoint)
    return fired


def records(root):
    camp = lm_campaign()
    return {r.name: json.loads((root / "lm-tiny" / r.key / "record.json")
                               .read_text())
            for s in camp.stages for r in s.runs}


def test_killed_and_resumed_run_equals_an_uninterrupted_one(
        tmp_path, monkeypatch, capsys):
    camp = lm_campaign()
    ref = Runner(camp, store=ResultStore(tmp_path / "ref" / "doc.json"),
                 state_root=tmp_path / "ref", device="cpu").run()
    assert ref.exit_code == 0 and ref.executed == 3

    root = tmp_path / "killed"
    store = ResultStore(root / "doc.json")
    fired = kill_at(monkeypatch, "u", 2)
    with pytest.raises(KeyboardInterrupt):
        Runner(camp, store=store, state_root=root, device="cpu").run()
    assert fired == [2]
    u = camp.stages[0].runs[1]
    assert not (root / "lm-tiny" / u.key / "record.json").exists()
    assert npz.latest_step(root / "lm-tiny" / u.key / "ckpt") == 2
    capsys.readouterr()

    summary = Runner(camp, store=store, state_root=root, device="cpu",
                     resume=True).run()
    out = capsys.readouterr().out
    q = camp.stages[0].runs[0]
    assert f"run,base,{q.key},q,skipped\n" in out
    assert "[lm-campaign] resumed u at step 2" in out
    assert (summary.executed, summary.skipped, summary.exit_code) == (2, 1, 0)
    got, want = records(root), records(tmp_path / "ref")
    assert got["u"]["data"]["resumed_from"] == 2
    assert want["u"]["data"]["resumed_from"] == 0
    for name in ("q", "u", "g"):
        for k in ("loss_history", "total_bits", "final_loss"):
            assert got[name]["data"][k] == want[name]["data"][k], (name, k)
        assert got[name]["claims"] == want[name]["claims"]
    assert {c["name"]: c["ok"] for c in got["u"]["claims"]} == {
        "lm_u_loss_finite": True, "lm_quantization_saves_bits": True}
    # the resumed run's last checkpoint holds the uninterrupted run's
    # engine state, bit for bit
    with np.load(root / "lm-tiny" / u.key / "ckpt" / "step_4.npz") as a, \
            np.load(tmp_path / "ref" / "lm-tiny" / u.key / "ckpt" /
                    "step_4.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        assert "['state']['quant']['initialized']" in a.files
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_only_runs_the_baseline_first_and_a_missing_section_is_fatal(
        tmp_path, capsys):
    camp = lm_campaign(steps=2, ckpt_every=1)
    summary = Runner(camp, store=ResultStore(tmp_path / "a" / "doc.json"),
                     state_root=tmp_path / "a", device="cpu",
                     only="grid").run()
    assert (summary.executed, summary.failed) == (3, 0)
    alone = Campaign(name="lm-tiny", stages=(
        Stage(name="base", runs=camp.stages[0].runs[1:]),))
    summary = Runner(alone, store=ResultStore(tmp_path / "b" / "doc.json"),
                     state_root=tmp_path / "b", device="cpu").run()
    assert summary.failed == 1
    assert "failed  # fatal: section ['lm', 'q'] missing" in \
        capsys.readouterr().out


def test_trainer_campaign_flags(tmp_path, monkeypatch):
    """``--campaign-only`` and ``--resume`` reach the runner; the summary
    is the JAX trainer's dict."""
    seen = []
    orig = prunner.Runner.__init__

    def init(self, campaign, **kw):
        seen.append((campaign.name, kw["resume"], kw["only"], kw["device"],
                     kw["state_root"]))
        orig(self, campaign, **kw)
    monkeypatch.setattr(prunner.Runner, "__init__", init)
    monkeypatch.setattr(prunner.Runner, "run", lambda self: prunner.Summary(
        self.campaign.name, []))
    out = train.main(["--campaign", "lm-sweep", "--device", "cpu",
                      "--resume", "--campaign-only", "lm-grid",
                      "--campaign-dir", str(tmp_path)])
    assert out == {"campaign": "lm-sweep", "executed": 0, "skipped": 0,
                   "failed": 0, "claim_failures": 0}
    assert seen == [("lm-sweep", True, "lm-grid", "cpu", tmp_path)]
