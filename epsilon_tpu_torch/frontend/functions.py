"""Loss-atom helpers (counterpart of ``epsilon_tpu/frontend/functions.py``,
``python/epopt/functions.py:15-66`` parity)."""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from . import api


def sqdist(X, Y):
    """Squared Euclidean distance between two point sets
    (``functions.py:6-11``)."""
    return (np.tile(np.sum(X ** 2, axis=1), (Y.shape[0], 1)).T
            + np.tile(np.sum(Y ** 2, axis=1), (X.shape[0], 1))
            - 2 * X.dot(Y.T))


def hinge_loss(theta, X, y):
    """sum(max(0, 1 - y_i x_i' theta)) (``functions.py:14-17``)."""
    y = np.asarray(y).ravel()
    if not np.array_equal(np.unique(y), [-1, 1]):
        raise ValueError("y must have binary labels in {-1,1}")
    return api.sum_entries(api.max_elemwise(
        1 - api._wrap(sp.diags([y], [0]) @ X) * theta, 0))


def logistic_loss(theta, X, y):
    y = np.asarray(y).ravel()
    if not np.array_equal(np.unique(y), [-1, 1]):
        raise ValueError("y must have binary labels in {-1,1}")
    return api.sum_entries(api.logistic(
        api._wrap(-sp.diags([y], [0]) @ X) * theta))


def one_hot(y, k, dtype=np.float64):
    y = np.asarray(y).ravel().astype(int)
    m = len(y)
    return np.asarray(sp.coo_matrix(
        (np.ones(m, dtype=dtype), (np.arange(m), y)),
        shape=(m, k)).todense())


def softmax_loss(Theta, X, y):
    """Multinomial logistic loss (``functions.py:28-33``)."""
    k = Theta.n
    X = np.asarray(X)
    # match the data dtype: a mixed f32 @ f64 product would copy the
    # feature matrix up to f64 before the product
    Y = one_hot(y, k, dtype=X.dtype)
    XtY = X.T @ Y
    XT = api._wrap(X)
    return (api.sum_entries(api.log_sum_exp(XT * Theta, axis=1))
            - api.sum_entries(api.mul_elemwise(XtY, Theta)))


def multiclass_hinge_loss(Theta, X, y):
    k = Theta.n
    Y = one_hot(y, k)
    XT = api._wrap(X)
    return (api.sum_entries(api.max_entries(XT * Theta + (1 - Y), axis=1))
            - api.sum_entries(api.mul_elemwise(np.asarray(X).T @ Y, Theta)))


def quantile_loss(alphas, Theta, X, y):
    """Multi-quantile pinball loss (``functions.py:42-52``)."""
    m, n = X.shape
    alphas = np.asarray(alphas).ravel()
    k = len(alphas)
    Y = np.tile(np.asarray(y).ravel(), (k, 1)).T
    A = np.tile(alphas, (m, 1))
    Z = api._wrap(X) * Theta - Y
    return api.sum_entries(api.max_elemwise(
        api.mul_elemwise(-A, Z), api.mul_elemwise(1 - A, Z)))


def poisson_loss(theta, X, y):
    y = np.asarray(y).ravel()
    return (api.sum_entries(api.exp(api._wrap(X) * theta))
            - api.sum_entries(api._wrap(sp.diags([y], [0]) @ X) * theta))


def infinite_push(theta, Xp, Xn):
    """Infinite-push ranking loss (``functions.py:59-66``)."""
    m, d = Xp.shape
    n = Xn.shape[0]
    Z = api.max_elemwise(
        1 - (api._wrap(Xp) * theta * np.ones((1, n))
             - api.transpose(api._wrap(Xn) * theta * np.ones((1, m)))), 0)
    return api.max_entries(api.sum_entries(Z, axis=0))
