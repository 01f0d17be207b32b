"""Frozen copies of the upstream problem generators, on a seeded
``numpy.random.Generator`` and free of the program under test.  Each takes two generators, one for the
structure and one for the noise.  The upstream generators fix both with
``np.random.seed(0)``; the benchmark fixes them with a configuration's own
seeds, and the run's ``--seed`` only reorders and mirrors the data in ways
that leave the work unchanged (``problems/tv1d.py``, ``problems/covsel.py``).

- :func:`tv1d_signals`: ``epopt/problems/tv_1d.py`` (the port keeps it as
  ``epsilon_tpu_torch/problems/tv_1d.py:8-21``): a signal of ones with
  ``k = sqrt(n)/2`` random intervals each shifted by ``10 (U - 1/2)``, plus
  standard normal noise; the denoising weight is ``sqrt(n)``.
- :func:`covsel_covariance`: ``epopt/problems/covsel.py``
  (``epsilon_tpu_torch/problems/covsel.py:9-26``): a sparse random factor
  of density 0.01, ``A = F^T F + 0.1 I``, ``m = n`` samples drawn with
  covariance ``A^-1``, and their sample covariance.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp


def tv1d_signals(n: int, count: int, structure: np.random.Generator,
                 noise: np.random.Generator) -> np.ndarray:
    """``count`` noisy piecewise-constant signals of length ``n``, float64,
    shape ``(count, n)``: the intervals and shifts drawn from ``structure``,
    the noise from ``noise``."""
    k = max(int(np.sqrt(n) / 2), 1)
    out = np.empty((count, n))
    for row in out:
        idxs = np.sort(structure.integers(0, n, (k, 2)), axis=1)
        shifts = 10.0 * (structure.random(k) - 0.5)
        steps = np.zeros(n + 1)
        np.add.at(steps, idxs[:, 0], shifts)
        np.add.at(steps, idxs[:, 1], -shifts)
        row[:] = 1.0 + np.cumsum(steps[:n])
    out += noise.standard_normal((count, n))
    return out


def tv1d_weight(n: int) -> float:
    return float(np.sqrt(n))


def covsel_covariance(n: int, structure: np.random.Generator, samples: np.random.Generator,
                      density: float = 0.01) -> np.ndarray:
    """The sample covariance ``S`` (n x n, float64) of ``n`` samples: the
    sparse factor drawn from ``structure``, the samples from ``samples``."""
    F = sp.random(n, n, density=density, random_state=structure)
    A = np.asarray((F.T @ F).todense()) + 0.1 * np.eye(n)
    L = np.linalg.cholesky(np.linalg.inv(A))
    X = samples.standard_normal((n, n)) @ L.T
    return X.T @ X / n


def covsel_weights(n: int) -> np.ndarray:
    """W = 1 - I: the diagonal is not penalised."""
    return np.ones((n, n)) - np.eye(n)


def lambda_path(lam_max: float, count: int, min_ratio: float) -> np.ndarray:
    """``count`` values from ``lam_max`` down to ``min_ratio * lam_max``,
    evenly spaced in log (the ``huge`` package's glasso path)."""
    return lam_max * np.exp(np.linspace(0.0, np.log(min_ratio), count))


def covsel_lambda_max(S: np.ndarray) -> float:
    """The least lambda at which the solution is diagonal: the largest
    off-diagonal |S_ij|."""
    off = np.abs(S - np.diag(np.diag(S)))
    return float(off.max())
