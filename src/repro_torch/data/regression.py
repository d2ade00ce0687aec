"""Datasets for the paper's experiments (Table 1) + uniform partitioner.

The port's own numpy copy of ``repro.data.regression``: the same seed gives
the same arrays, bit for bit. Only the synthetic sets and the statistically
matched surrogates of Body Fat and Derm are here; the port reads no real-data
file.

* synth-linear / synth-logistic: synthetic sets in the style of Chen et al.
  (2018) ("LAG"): d=50, 1200 instances. Features drawn N(0, I) with a mild
  condition-number spread; linear targets use a fixed ground-truth theta with
  Gaussian noise; logistic labels are sampled from the true logit.
* Body Fat (d=14, 252 rows) and Derm (d=34, 358 rows) surrogates: same d,
  same n, standardized features, realistic column correlations.

Samples are distributed uniformly across N workers (Sec. 7: "the number of
samples are uniformly distributed across the N workers").
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class RegressionData:
    x: np.ndarray          # (n_samples, d)
    y: np.ndarray          # (n_samples,)
    task: str              # "linear" | "logistic"
    name: str

    @property
    def dim(self) -> int:
        return self.x.shape[1]


def _feature_matrix(rng: np.random.Generator, n: int, d: int,
                    cond: float = 10.0) -> np.ndarray:
    """Gaussian features with eigenvalue spread (condition number ~cond)."""
    base = rng.standard_normal((n, d))
    scales = np.geomspace(1.0, 1.0 / cond, d)
    return (base * scales[None, :]).astype(np.float32)


def synth_linear(n: int = 1200, d: int = 50, noise: float = 0.1,
                 seed: int = 0) -> RegressionData:
    rng = np.random.default_rng(seed)
    x = _feature_matrix(rng, n, d)
    theta_true = rng.standard_normal(d).astype(np.float32)
    y = x @ theta_true + noise * rng.standard_normal(n).astype(np.float32)
    return RegressionData(x=x, y=y.astype(np.float32), task="linear",
                          name="synth-linear")


def synth_logistic(n: int = 1200, d: int = 50, seed: int = 0) -> RegressionData:
    rng = np.random.default_rng(seed)
    x = _feature_matrix(rng, n, d)
    theta_true = rng.standard_normal(d).astype(np.float32)
    logits = x @ theta_true
    probs = 1.0 / (1.0 + np.exp(-logits))
    y = np.where(rng.uniform(size=n) < probs, 1.0, -1.0)
    return RegressionData(x=x, y=y.astype(np.float32), task="logistic",
                          name="synth-logistic")


def body_fat(seed: int = 1) -> RegressionData:
    """Body Fat surrogate: 252 x 14, linear regression target."""
    rng = np.random.default_rng(seed)
    n, d = 252, 14
    # correlated anthropometric-style columns
    corr_root = rng.uniform(0.3, 1.0, size=(d, d)) * rng.choice(
        [0.0, 1.0], p=[0.6, 0.4], size=(d, d))
    np.fill_diagonal(corr_root, 1.0)
    x = rng.standard_normal((n, d)) @ (corr_root / np.sqrt(d))
    x = ((x - x.mean(0)) / (x.std(0) + 1e-9)).astype(np.float32)
    w = rng.standard_normal(d).astype(np.float32)
    y = x @ w + 0.3 * rng.standard_normal(n).astype(np.float32)
    return RegressionData(x=x, y=y.astype(np.float32), task="linear",
                          name="bodyfat-surrogate")


def derm(seed: int = 2) -> RegressionData:
    """Dermatology surrogate: 358 x 34, binarized diagnosis, logistic task."""
    rng = np.random.default_rng(seed)
    n, d = 358, 34
    x = rng.integers(0, 4, size=(n, d)).astype(np.float32)  # ordinal scores
    x = (x - x.mean(0)) / (x.std(0) + 1e-9)
    w = rng.standard_normal(d).astype(np.float32)
    logits = x @ w
    y = np.where(rng.uniform(size=n) < 1 / (1 + np.exp(-logits)), 1.0, -1.0)
    return RegressionData(x=x, y=y.astype(np.float32), task="logistic",
                          name="derm-surrogate")


def partition_uniform(data: RegressionData, n_workers: int,
                      seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """Shuffle and split rows uniformly across workers.

    Returns x (N, s, d), y (N, s) with s = floor(n / N) (tail dropped, as a
    uniform per-worker sample count is required by the batched solvers).
    """
    rng = np.random.default_rng(seed)
    order = rng.permutation(data.x.shape[0])
    s = data.x.shape[0] // n_workers
    idx = order[: s * n_workers].reshape(n_workers, s)
    return data.x[idx], data.y[idx]


DATASETS = {
    "synth-linear": synth_linear,
    "synth-logistic": synth_logistic,
    "bodyfat": body_fat,
    "derm": derm,
}
