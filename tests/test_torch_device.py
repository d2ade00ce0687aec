"""The port never runs on the CPU unless asked, its kernels' entry points
take the plain versions only for CPU tensors, and it imports nothing of JAX
or of the JAX package."""
import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import device as device_lib
from repro_torch import interop, quickstart
from repro_torch.configs import base
from repro_torch.core import admm_baselines as ab
from repro_torch.core import cq_ggadmm
from repro_torch.core import engine as E
from repro_torch.core import topology
from repro_torch.core.dynamic import DynamicTopology, run_dynamic
from repro_torch.core.graph import chain_graph
from repro_torch.kernels import build, ops, ref
from repro_torch.launch import serve, train
from repro_torch.serving.scheduler import Scheduler, ServeConfig

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_resolve_device(no_cuda):
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        device_lib.resolve_device()
    with pytest.raises(RuntimeError):
        device_lib.resolve_device("cuda")
    assert device_lib.resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        device_lib.resolve_device("mps")


def test_entry_points_refuse_to_fall_back_to_the_cpu(no_cuda):
    g = chain_graph(4)
    tiny = base.get_smoke_config("tinyllama-1.1b")
    x = np.zeros((4, 3, 2), np.float32)
    y = np.zeros((4, 3), np.float32)
    cfg = ab.cq_ggadmm()
    prob = interop.problem_from_numpy(x, y, "linear", device="cpu")
    calls = [
        lambda: quickstart.part1(iters=1),
        lambda: quickstart.main(["--iters", "1"]),
        lambda: topology.build(g),
        lambda: topology.build(g, "sparse"),
        lambda: run_dynamic(DynamicTopology(4, refresh_every=1), prob, cfg,
                            2, 1),
        lambda: E.make_step(g, cfg, E.ExactSolver(prob)),
        lambda: E.flat_metrics(g),
        lambda: cq_ggadmm.init_state(4, 2, cfg),
        lambda: cq_ggadmm.make_step(g, prob, cfg),
        lambda: cq_ggadmm.run(g, prob, cfg, 2, 1),
        lambda: interop.problem_from_numpy(x, y, "linear"),
        lambda: interop.engine_state_from_numpy({}),
        lambda: interop.tree_from_numpy({}),
        lambda: train.main(["--smoke", "--steps", "1", "--batch", "4"]),
        lambda: serve.main(["--decode-tokens", "1"]),
        lambda: serve.LockstepEngine(tiny, None),
        lambda: Scheduler(tiny, None, ServeConfig()),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()


def _quant_args(device):
    rng = np.random.default_rng(0)
    theta, qprev, unif = (torch.tensor(rng.uniform(size=(3, 5)),
                                       dtype=torch.float32, device=device)
                          for _ in range(3))
    r = torch.amax(torch.abs(theta - qprev), dim=1)
    return theta, qprev, unif, r / 3.0, r


def test_ops_on_cpu_tensors_bump_no_launch_count():
    args = _quant_args("cpu")
    adj = torch.ones((3, 3))
    before = dict(ops.launches)
    torch.testing.assert_close(ops.stoch_quantize(*args),
                               ref.stoch_quantize_ref(*args), rtol=0, atol=0)
    torch.testing.assert_close(ops.bipartite_mix(adj, args[0]),
                               ref.bipartite_mix_ref(adj, args[0]),
                               rtol=0, atol=0)
    assert ops.launches == before
    ops.reset_launches()
    assert ops.launches == {k: 0 for k in ops.KERNELS}


def test_ops_on_other_devices_raise_instead_of_falling_back():
    args = _quant_args("meta")
    with pytest.raises(ValueError, match="CUDA"):
        ops.stoch_quantize(*args)
    with pytest.raises(ValueError, match="CUDA"):
        ops.bipartite_mix(torch.ones((3, 3), device="meta"), args[0])
    side = torch.zeros((3, 1), device="meta")
    runs = (((0, 5),),)
    with pytest.raises(ValueError, match="CUDA"):
        ops.stoch_quantize_grouped_fused(*args[:3], side, side, side, None,
                                         group_runs=runs, omega=0.99, b0=2,
                                         b_max=16)
    with pytest.raises(ValueError, match="CUDA"):
        ops.stoch_quantize_grouped_fused_tiled(
            *args[:3], side, side, side, None, group_runs=runs, omega=0.99,
            b0=2, b_max=16)
    with pytest.raises(ValueError, match="CUDA"):
        ops.stoch_quantize_grouped(*args[:3], side, side, None,
                                   group_runs=runs)
    with pytest.raises(ValueError, match="CUDA"):
        ops.edge_gather_mix(args[0], torch.zeros((3, 2), dtype=torch.int32,
                                                 device="meta"),
                            torch.ones((3, 2), device="meta"))
    pool = torch.zeros((4, 2, 1, 8), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        ops.paged_attention_decode(
            torch.zeros((2, 2, 8), device="meta"), pool, pool,
            torch.zeros((2, 3), dtype=torch.int32, device="meta"),
            torch.ones((2,), dtype=torch.int32, device="meta"))


@pytest.mark.parametrize("argv", [["--mode", "fsdp"],
                                  ["--campaign", "lm-sweep"],
                                  ["--trace", "t.json"],
                                  ["--fleet", "--trace", "t.json"]])
def test_train_flags_not_ported_exit_naming_roadmap(argv):
    with pytest.raises(SystemExit, match="ROADMAP"):
        train.main(["--smoke", "--device", "cpu"] + argv)


def test_train_fleet_flag_runs_and_refuses_regroup_every():
    """``--fleet`` runs (it exited before the fleet was ported) and, as in
    the JAX package, refuses ``--regroup-every``; a bad churn spec exits."""
    argv = ["--smoke", "--device", "cpu", "--workers", "2", "--batch", "2",
            "--seq", "8", "--steps", "1", "--local-steps", "1", "--fleet"]
    out = train.main(argv + ["--mix-backend", "sparse"])
    assert np.isfinite(out["history"]).all() and len(out["history"]) == 1
    with pytest.raises(SystemExit, match="regroup-every"):
        train.main(argv + ["--groups", "auto:2", "--regroup-every", "1"])
    with pytest.raises(SystemExit, match="fleet-churn"):
        train.main(argv + ["--fleet-churn", "1:1"])


def test_kernel_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(build.KernelBuildError, match="nvcc not found"):
        build.build_all()


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_port_imports_neither_jax_nor_the_jax_package():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 15
    scanned = {p.relative_to(ROOT).parts[2] for p in files[:-1]}
    assert {"serving", "launch", "models", "kernels", "fleet"} <= scanned
    for path in files:
        roots = set(_imported_roots(path))
        assert not roots & {"jax", "jaxlib", "repro"}, (path, roots)
