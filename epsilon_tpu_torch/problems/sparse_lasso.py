"""Lasso with a sparse data matrix (benchmark.py lasso_sparse config)."""

from . import lasso


def create(**kwargs):
    kwargs.setdefault("mu", 0.1)
    return lasso.create(**kwargs)
