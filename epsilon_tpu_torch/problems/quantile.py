"""Multiple quantile regression with RBF features (``problems/quantile.py``)."""

import numpy as np

import epsilon_tpu_torch as ep


def create(m, n, k, p=1, sigma=0.1):
    np.random.seed(0)
    x = np.random.rand(m) * 2 * np.pi * p
    y = np.sin(x) + sigma * np.sin(x) * np.random.randn(m)
    alphas = np.linspace(1.0 / (k + 1), 1 - 1.0 / (k + 1), k)

    mu_rbf = np.array([np.linspace(-1, 2 * np.pi * p + 1, n)])
    mu_sig = (2 * np.pi * p + 2) / n
    X = np.exp(-(mu_rbf.T - x).T ** 2 / (2 * mu_sig ** 2))

    Theta = ep.Variable(n, k)
    f = ep.quantile_loss(alphas, Theta, X, y)
    # noncrossing constraints
    C = [ep._wrap(X) * (Theta[:, :-1] - Theta[:, 1:]) >= 0] if k > 1 else []
    return ep.Problem(ep.Minimize(f), C)
