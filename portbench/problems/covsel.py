"""Sparse inverse-covariance selection (the graphical lasso):

    minimize  lam ||W o Theta||_1 + <S, Theta> - log det Theta,  W = 1 - I.

One sample covariance ``S``
(:func:`generators.covsel_covariance`), its variables permuted by the
seed; the instances are the points of a
lambda path from the largest off-diagonal |S_ij| down (the ``huge``
package's defaults: 10 values to a tenth).  ``S`` and ``lam`` are
Parameters.  The linear term <S, Theta> is stated as vec(S)^T vec(Theta):
the upstream generator's ``sum_entries(mul_elemwise(S, Theta))`` makes the
program's compiler form a dense p^2 x p^2 matrix from p = 400 on.  The reference solves each checked lambda again in float64 on
the device (:mod:`portbench.reference.covsel`).
"""

from __future__ import annotations

import numpy as np
import torch

from ..reference import covsel as ref_covsel
from . import generators


def generate(cfg, mix, rng):
    """S from the configuration's own seeds (its sparse factor and its
    samples), so every run asks for the same work; the run's ``rng``
    permutes the variables, which leaves the solves' work unchanged (the
    answer is the permuted answer)."""
    p = int(cfg["p"])
    S = generators.covsel_covariance(p, np.random.default_rng(int(cfg["structure_seed"])),
                                     np.random.default_rng(int(cfg["samples_seed"])),
                                     float(cfg["factor_density"]))
    perm = rng.permutation(p)
    S = np.ascontiguousarray(S[np.ix_(perm, perm)])
    lams = generators.lambda_path(generators.covsel_lambda_max(S), int(mix["count"]),
                                  float(mix["min_ratio"]))
    return {"S": S, "W": generators.covsel_weights(p), "lams": lams}


def instances(cfg, mix, data):
    s_row = data["S"].reshape(1, -1, order="F")
    return [{"S": s_row, "lam": np.array([[lam]])} for lam in data["lams"]]


def build(ep, cfg, data, values, parametric):
    if cfg["linear_term"] != "vec(S)^T vec(Theta)":
        raise ValueError(f"unknown linear_term {cfg['linear_term']!r}")
    p = int(cfg["p"])
    theta = ep.Variable(p, p)
    if parametric:
        params = {"S": ep.Parameter(1, p * p, value=values["S"]),
                  "lam": ep.Parameter(1, 1, value=values["lam"])}
        S, lam = params["S"], params["lam"]
    else:
        params, S, lam = {}, values["S"], float(values["lam"][0, 0])
    prob = ep.Problem(ep.Minimize(
        lam * ep.norm1(ep.vec(ep.mul_elemwise(data["W"], theta)))
        + S * ep.vec(theta)
        - ep.log_det(theta)))
    return prob, params, theta


def answer(variable):
    return np.asarray(variable.value)


def references(cfg, data, values_list, control=False, device="cuda"):
    """Each instance's Theta, solved again from S and lam: float64, or with
    ``control`` in float32 with TF32 matrix products."""
    S = torch.as_tensor(data["S"], dtype=torch.float64, device=device)
    W = torch.as_tensor(data["W"], dtype=torch.float64, device=device)
    opts = dict(cfg["reference"])
    low_iterations = opts.pop("control_max_iterations", None)
    if control and low_iterations:
        opts["max_iterations"] = low_iterations
    out = []
    for values in values_list:
        res = ref_covsel.glasso(S, W, float(values["lam"][0, 0]), matmul_tf32=control, **opts)
        out.append(res.theta.to(torch.float64).cpu().numpy())
    return out


def compare(cfg, data, values, got, ref):
    """Theta's distance from the reference in the Frobenius norm, relative
    to the reference's; its largest elementwise gap relative to the
    reference's largest entry; and its own asymmetry, max |Theta -
    Theta^T| / max |Theta|, which reads the precision of the arithmetic
    that reconstructs it from its eigendecomposition."""
    if got is None or got.shape != ref.shape or not np.all(np.isfinite(got)):
        return {"rel_err": np.inf, "max_err": np.inf, "asym": np.inf}
    got = got.astype(np.float64)
    return {"rel_err": float(np.linalg.norm(got - ref) / np.linalg.norm(ref)),
            "max_err": float(np.abs(got - ref).max() / np.abs(ref).max()),
            "asym": float(np.abs(got - got.T).max() / np.abs(got).max())}
