"""Spread of the cq-ggadmm bit total between the port and the JAX reference.

Not a test: a measurement behind the 3% bit tolerance of
``test_torch_engine.py::test_cq_ggadmm_matches_jax_with_injected_uniforms``
(ROADMAP.md, C). On quickstart part 1 (24 workers, synth-linear d=50,
p=0.35, 300 iterations) and for each seed it prints the cumulative bits of

* the JAX reference (dense jnp path),
* the JAX reference with its data scaled by 1 + 2^-22 (about one float32
  ulp), the chaos of the chain itself,
* the port on the CPU with the reference's uniforms injected, and
* the same with the local solve in float64,

each relative to the first. Run on the CPU:

    PYTHONPATH=src python tests/torch_bits_spread.py [--seeds 8]
"""
import argparse

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.core import admm_baselines as jab
from repro.core import engine as JE
from repro.core.graph import random_bipartite_graph as jax_graph
from repro.core.solvers import LinearRegressionProblem as JaxLinear
from repro_torch.core import admm_baselines as ab
from repro_torch.core import engine as E
from repro_torch.core.graph import random_bipartite_graph
from repro_torch.core.solvers import LinearRegressionProblem
from repro_torch.data import regression as R

N, D, ITERS = 24, 50, 300


class Float64Solve(LinearRegressionProblem):
    def primal_solve(self, v, rho_d, theta_init=None):
        eye = torch.eye(self.dim, dtype=torch.float64)
        lhs = self.gram.double() + rho_d.double()[:, None, None] * eye
        return torch.linalg.solve(lhs, (self.xty - v).double()).float()


def jax_uniforms(seed):
    def one(key):
        k1, k2 = jax.random.split(key)
        return jnp.stack([jax.random.uniform(k1, (N, D), jnp.float32),
                          jax.random.uniform(k2, (N, D), jnp.float32)])
    keys = jax.random.split(jax.random.PRNGKey(seed), ITERS)
    return np.asarray(jax.jit(jax.vmap(one))(keys))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, default=8)
    args = ap.parse_args()
    x, y = R.partition_uniform(R.synth_linear(), N)
    jg, g = jax_graph(N, 0.35, seed=0), random_bipartite_graph(N, 0.35, 0)
    jcfg, cfg = jab.cq_ggadmm(rho=1.0), ab.cq_ggadmm(rho=1.0)
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    ports = {"port": LinearRegressionProblem(xt, yt),
             "port-f64-solve": Float64Solve(xt, yt)}

    def jax_bits(scale, seed):
        prob = JaxLinear(jnp.asarray(x) * scale, jnp.asarray(y))
        _, out = JE.run(jg, jcfg, JE.ExactSolver(prob),
                        jnp.zeros((N, D), jnp.float32), ITERS, seed=seed)
        return float(np.asarray(out["payload_bits"]).sum())

    rel = {k: [] for k in ["jax-1ulp", *ports]}
    for seed in range(args.seeds):
        ref = jax_bits(1.0, seed)
        row = {"jax-1ulp": jax_bits(1.0 + 2.0 ** -22, seed)}
        u = jax_uniforms(seed)
        for name, prob in ports.items():
            _, out = E.run(g, cfg, E.ExactSolver(prob), torch.zeros((N, D)),
                           ITERS, uniforms=lambda it, ph: torch.from_numpy(
                               u[it, ph].copy()))
            row[name] = float(out["payload_bits"].sum())
        print(f"seed {seed}: jax {ref:.5e}  " + "  ".join(
            f"{k} {v:.5e} ({v / ref - 1:+.2%})" for k, v in row.items()),
            flush=True)
        for k, v in row.items():
            rel[k].append(v / ref - 1)
    print("mean relative to jax: " + "  ".join(
        f"{k} {np.mean(v):+.2%} (max |.| {np.max(np.abs(v)):.2%})"
        for k, v in rel.items()))


if __name__ == "__main__":
    main()
