"""The ``kernels`` and ``roofline`` stages of campaign ``all``
(``repro_torch/bench/kernels.py``, ``repro_torch/bench/roofline.py``) and
the ``all`` campaign itself, on the CPU:

* each roofline row's bytes, operations and bound equal PERF.md's kernel
  table: B1 (64, 2000) 0.61 us, B2 at the LM shape 1.283 ms, B3/B4/B5 at
  the full-width xlstm-125m buffer 2.565 ms, B9 (8, 700) 100.6 us, and the
  rest of its rows;
* on the CPU every row is ``missing`` (bound, no time) and
  ``roofline_no_failed_records`` holds, under the JAX stage's section and
  claim name; a launch that raises makes its row ``fail``;
* the kernels stage holds its parity claims at the JAX package's three
  shapes;
* ``all`` has the JAX campaign's stages, deps, run names and configs in
  its order, with ``fn`` naming the port's modules.
"""
import json

import pytest
import torch

import benchmarks.bench_roofline as JR
from benchmarks import campaigns as jcampaigns
from repro_torch.bench import campaigns, roofline
from repro_torch.launch import train
from test_torch_bench_serving import _claims_in_source

# (kernel, shape prefix) -> (bound in ms, what sets it), PERF.md's table
PERF_BOUNDS = {
    ("B1", "(64, 2000)"): (0.61e-3, "bytes"),
    ("B2", "(64, 64)"): (0.31e-3, "bytes"),
    ("B2", "(1024, 1024)"): (62.6e-3, "operations"),
    ("B2", "LM (4, 4)"): (1.283, "bytes"),
    ("B3", "(4, 134277912)"): (2.565, "bytes"),
    ("B4", "(4, 134277912)"): (2.565, "bytes"),
    ("B5", "(4, 134277912)"): (2.565, "bytes"),
    ("B6", "LM (4,"): (1.283, "bytes"),
    # V's 257 rows read and written once, the (257, 256) table and validity
    ("B6", "star"): ((8 * 257 * 2000 + 8 * 257 * 256) / 3.35e9, "bytes"),
    ("B7", "stream"): (0.86e-3, "bytes"),
    ("B7", "load"): (4.18e-3, "bytes"),
    ("B8", "3968"): (1.26e-3, "bytes"),
    ("B9", "paged chunk (1, 64)"): (1.15e-3, "operations"),
    ("B9", "lockstep prefill (8, 700)"): (100.6e-3, "operations"),
    ("B2", "convex 2 ranks"): (0.2317e-3, "bytes"),
    ("B2", "convex 4 ranks"): (0.1923e-3, "bytes"),
    ("B2", "LM 2 ranks"): (30.05e-3, "bytes"),
    ("B2", "LM 4 ranks"): (25.04e-3, "bytes"),
}
MODULES = {"benchmarks.bench_engine": "repro_torch.bench.engine",
           "benchmarks.bench_serving": "repro_torch.bench.serving",
           "benchmarks.bench_figures": "repro_torch.bench.figures",
           "benchmarks.bench_fleet": "repro_torch.bench.fleet",
           "benchmarks.bench_kernels": "repro_torch.bench.kernels",
           "benchmarks.bench_roofline": "repro_torch.bench.roofline",
           "repro.launch.train": "repro_torch.launch.train"}


def _row(records, kernel, prefix):
    hits = [r for r in records
            if r["kernel"] == kernel and r["shape"].startswith(prefix)]
    assert len(hits) == 1, (kernel, prefix, hits)
    return hits[0]


def test_roofline_bounds_equal_the_perf_table():
    records = [roofline.measure(r, None) for r in roofline.rows()]
    assert len(records) == len(PERF_BOUNDS)
    for (kernel, prefix), (ms, by) in PERF_BOUNDS.items():
        r = _row(records, kernel, prefix)
        assert r["bound_ms"] == pytest.approx(ms, rel=5e-3), (kernel, prefix)
        assert r["bound_by"] == by and r["status"] == "missing"
        assert "ms" not in r and "share" not in r
    assert sum(roofline.lm_leaf_dims()) == 134277912
    b3 = _row(records, "B3", "(4,")
    assert b3["bytes"] == 16 * 4 * 134277912
    assert b3["shape"].endswith("G=19")


def test_roofline_stage_on_the_cpu_records_missing_rows(tmp_path):
    out = train.main(["--campaign", "all", "--campaign-only", "roofline",
                      "--device", "cpu", "--campaign-dir", str(tmp_path)])
    assert out == {"campaign": "all", "executed": 1, "skipped": 0,
                   "failed": 0, "claim_failures": 0}
    doc = json.loads((tmp_path / "BENCH_engine.json").read_text())
    section = doc["roofline"]
    assert section["claims"] == {"roofline_no_failed_records": True}
    assert {r["status"] for m in ("single", "multi")
            for r in section[m]} == {"missing"}
    assert len(section["multi"]) == len(roofline.ROW_BLOCKS)
    assert section["card"] is None and "all-gather" in section["multi_note"]


def test_roofline_section_and_claim_are_the_jax_stages():
    assert _claims_in_source(roofline.stage_roofline) == _claims_in_source(
        JR.stage_roofline)


def test_a_launch_that_raises_makes_its_row_fail():
    def make(dev):
        raise RuntimeError("no kernel here")
    row = roofline.Row("single", "B1", "stoch_quantize", "(1, 1)",
                       roofline.quant_work(1, 1), make)
    rec = roofline.measure(row, torch.device("cuda"), "a card")
    assert rec["status"] == "fail" and "no kernel here" in rec["error"]
    assert rec["card"] == "a card"


def test_kernels_stage_holds_its_parity_claims(tmp_path, capsys):
    out = train.main(["--campaign", "all", "--campaign-only", "kernels",
                      "--device", "cpu", "--campaign-dir", str(tmp_path)])
    assert out == {"campaign": "all", "executed": 3, "skipped": 0,
                   "failed": 0, "claim_failures": 0}
    doc = json.loads((tmp_path / "BENCH_engine.json").read_text())
    kern = doc["kernels"]
    assert sorted(kern) == ["16x4096", "24x16384", "8x512", "claims"]
    assert sorted(kern["claims"]) == sorted(
        f"{k}_parity_{s}" for k in ("stoch_quant", "bipartite_mix")
        for s in ("8x512", "16x4096", "24x16384"))
    assert all(kern["claims"].values())
    for shape in ("8x512", "16x4096", "24x16384"):
        assert set(kern[shape]) == {"n", "d", "stoch_quant",
                                    "bipartite_mix"}
        assert set(kern[shape]["stoch_quant"]) == {
            "us_per_call", "us_ref", "max_abs_diff"}
    text = capsys.readouterr().out
    assert "'stoch_quantize': 12, 'bipartite_mix': 12" in text


@pytest.mark.parametrize("name", ["kernels", "roofline", "lm-swep"])
def test_an_unknown_campaign_raises_the_jax_packages_key_error(name):
    with pytest.raises(KeyError) as want:
        jcampaigns.get(name)
    with pytest.raises(KeyError) as got:
        campaigns.get(name)
    assert str(got.value) == str(want.value)


def test_all_is_the_jax_campaign_with_the_ports_modules():
    port, jax_ = campaigns.get("all"), jcampaigns.get("all")
    assert [(s.name, s.deps) for s in port.stages] == [
        (s.name, s.deps) for s in jax_.stages]
    for ps, js in zip(port.stages, jax_.stages):
        assert [(r.name, dict(r.config)) for r in ps.runs] == [
            (r.name, dict(r.config)) for r in js.runs]
        for pr, jr in zip(ps.runs, js.runs):
            module, fn = jr.fn.split(":")
            assert pr.fn == f"{MODULES[module]}:{fn}"
            pr.resolve()                      # the function exists
    assert [s.name for s in port.stages][7:9] == ["kernels", "roofline"]
