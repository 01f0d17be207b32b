"""Multivariate lasso (``problems/benchmark.py`` mv_lasso config)."""

from . import lasso


def create(**kwargs):
    kwargs.setdefault("k", 10)
    return lasso.create(**kwargs)
