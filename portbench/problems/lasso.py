"""The lasso (upstream ``epopt/problems/lasso.py``):

    minimize  ||A x - b||^2 + lam ||x||_1

A and b from the upstream generator's recipe (:func:`regression`), A's
columns permuted by the seed;
the instances are a lambda path from the least lambda at which x* = 0,
2 ||A^T b||_inf, down (glmnet's defaults: 100 values to a hundredth where
there are fewer rows than columns).  ``lam`` is a 1 x 1 Parameter.  The
reference solves each checked lambda again in float64 on the device
(:mod:`portbench.reference.lasso`), and the path's last lambda besides,
whose answer, the densest, sets the scale of ``rel_err``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..reference import lasso as ref_lasso
from . import generators


def generate(cfg, mix, rng):
    """A and b from the configuration's own seeds (A and x0 from
    ``structure_seed``, the noise from ``noise_seed``), so every run asks
    for the same work; the run's ``rng`` permutes A's columns, which leaves
    the solves' work unchanged (the answer is the permuted answer)."""
    m, n = int(cfg["m"]), int(cfg["n"])
    A, b = regression(m, n, np.random.default_rng(int(cfg["structure_seed"])),
                      np.random.default_rng(int(cfg["noise_seed"])),
                      float(cfg["x0_density"]), float(cfg["sigma"]))
    A = np.ascontiguousarray(A[:, rng.permutation(n)])
    lams = generators.lambda_path(lambda_max(A, b), int(mix["count"]), float(mix["min_ratio"]))
    return {"A": A, "b": b, "lams": lams}


def regression(m: int, n: int, structure: np.random.Generator, noise: np.random.Generator,
               density: float, sigma: float):
    """A frozen copy of the upstream ``problem_util.create_regression`` (the
    port keeps it as ``epsilon_tpu_torch/problems/problem_util.py``) on
    seeded generators: A Gaussian with unit-norm columns and a sparse x0 of
    ``round(density n)`` N(0, 1) entries from ``structure``; b = A x0 +
    sigma N(0, 1) with the noise from ``noise``.  Float64."""
    A = structure.standard_normal((m, n))
    A /= np.sqrt(np.sum(A ** 2, axis=0))
    x0 = np.zeros(n)
    support = structure.choice(n, size=int(round(density * n)), replace=False)
    x0[support] = structure.standard_normal(support.size)
    return A, A @ x0 + sigma * noise.standard_normal(m)


def lambda_max(A, b) -> float:
    """The least lambda at which x* = 0: 2 ||A^T b||_inf (the gradient of
    ||A x - b||^2 at 0 is -2 A^T b)."""
    return float(2.0 * np.abs(A.T @ b).max())


def instances(cfg, mix, data):
    return [{"lam": np.array([[lam]])} for lam in data["lams"]]


def build(ep, cfg, data, values, parametric):
    """The upstream statement, ``lam`` a Parameter when ``parametric``."""
    x = ep.Variable(int(cfg["n"]))
    if parametric:
        params = {"lam": ep.Parameter(1, 1, value=values["lam"])}
        lam = params["lam"]
    else:
        params, lam = {}, float(values["lam"][0, 0])
    A, b = data["A"], data["b"]
    prob = ep.Problem(ep.Minimize(ep.sum_squares(A * x - b) + lam * ep.norm1(x)))
    return prob, params, x


def answer(variable):
    return np.asarray(variable.value, dtype=np.float64).ravel()


def references(cfg, data, values_list, control=False, device="cuda"):
    """Each instance's x*, solved again from A, b and lam: float64, or with
    ``control`` every product's inputs rounded to bfloat16.  In float64 it
    also solves the path's last lambda, whose ||x*|| is ``rel_err``'s scale
    (``data["scale"]``)."""
    A = torch.as_tensor(data["A"], dtype=torch.float64, device=device)
    b = torch.as_tensor(data["b"], dtype=torch.float64, device=device)
    opts = dict(cfg["reference"])
    low_iterations = opts.pop("control_max_iterations", None)
    if control and low_iterations:
        opts["max_iterations"] = low_iterations
    L = ref_lasso.lipschitz(A)

    def solve(lam):
        res = ref_lasso.lasso(A, b, lam, control=control, L=L, **opts)
        return res.x.cpu().numpy()

    out = [solve(float(v["lam"][0, 0])) for v in values_list]
    if not control:
        data["scale"] = float(np.linalg.norm(solve(float(data["lams"][-1]))))
    return out


def compare(cfg, data, values, got, ref):
    """``rel_err``: x's distance from x*, relative to ||x*|| at the path's
    last lambda (x* = 0 at lambda_max, so no instance's own norm serves);
    ``obj_gap``: (F(x) - F(x*)) / F(x*), in float64, F(x*) > 0 on every
    lambda (||b||^2 where x* = 0, else lam ||x*||_1 > 0 adds to it)."""
    if got is None or got.shape != ref.shape or not np.all(np.isfinite(got)):
        return {"rel_err": np.inf, "obj_gap": np.inf}
    lam = float(values["lam"][0, 0])
    A, b = data["A"], data["b"]

    def F(x):
        r = A @ x - b
        return float(r @ r + lam * np.abs(x).sum())

    f_ref = F(ref)
    return {"rel_err": float(np.linalg.norm(got - ref) / data["scale"]),
            "obj_gap": float((F(got.astype(np.float64)) - f_ref) / f_ref)}
