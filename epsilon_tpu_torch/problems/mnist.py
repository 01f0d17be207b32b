"""MNIST-style multiclass classification with random-Fourier features
(``problems/mnist.py:46-63``).  Data is synthesized (class-conditional
Gaussians) so the generator has no external data dependencies; the model
structure (kitchen-sink features + multiclass softmax + elementwise l1)
matches the reference benchmark.  Counterpart of
``epsilon_tpu/problems/mnist.py``: the features are made on the host.
"""

import numpy as np

import epsilon_tpu_torch as ep
from epsilon_tpu_torch import config


def _synthetic_digits(m, dim=50, k=10, seed=0):
    rng = np.random.RandomState(seed)
    dtype = config.default_np_dtype()
    centers = rng.randn(k, dim).astype(dtype) * 2
    y = rng.randint(0, k, m)
    X = centers[y] + rng.randn(m, dim).astype(dtype)
    return X, y


def kitchen_sink_features(X, n, sigma=None, seed=1):
    """Random Fourier features for the RBF kernel (``mnist.py:46-54``), in
    the solver dtype (f32 on the card)."""
    rng = np.random.RandomState(seed)
    dtype = config.default_np_dtype()
    d = X.shape[1]
    if sigma is None:
        sigma = np.sqrt(d)
    W = (rng.randn(d, n) / sigma).astype(dtype)
    b = rng.uniform(0, 2 * np.pi, n).astype(dtype)
    scale = np.asarray(np.sqrt(2.0 / n), dtype=dtype)
    return scale * np.cos(np.asarray(X, dtype=dtype).dot(W) + b)


def create(m=200, n=100, k=10, lam=0.1):
    """Build the MNIST-RFF softmax problem."""
    X, y = _synthetic_digits(m, k=k)
    F = kitchen_sink_features(X, n)
    Theta = ep.Variable(n, k)
    f = ep.softmax_loss(Theta, F, y) + lam * ep.norm1(ep.vec(Theta))
    return ep.Problem(ep.Minimize(f))
