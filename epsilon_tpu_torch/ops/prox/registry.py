"""Canonical prox kernel registry.

Counterpart of ``epsilon_tpu/ops/prox/registry.py``: maps each
:class:`~epsilon_tpu_torch.ir.ProxKind` to its canonical-form kernels,

- ``prox(v, lam, **params) -> x``  solving argmin f(x) + ||x-v||^2/(2*lam)
- ``epi(v, s, **params) -> (x, t)`` projection onto {f(x) <= t}
- ``feval(x, **params) -> f(x)``    function value

``elementwise=True`` kernels accept a per-coordinate ``lam``; the others
take a number (or one per problem of a batch).  ``stateful_prox`` and
``state_init`` are the warm-startable form of iteratively solved kernels
(TV-1D: the PDAS dual).  ``capturable`` marks a prox whose call launches
plain elementwise device work alone (no host sync, no host read of device
data, no loop on the host), which a CUDA graph of the ADMM epoch may
capture.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import torch

from ...ir import ProxKind
from ..kernels import epi_sum_square
from . import elementwise as ew
from . import matrix as mx
from . import newton_epi as ne
from . import tv1d
from . import vector as vec
from .util import as_tensor_like, newton_safeguarded, where_batch


@dataclasses.dataclass
class KernelEntry:
    prox: Optional[Callable] = None
    epi: Optional[Callable] = None
    feval: Optional[Callable] = None
    elementwise: bool = False   # supports vector lam
    matrix: bool = False        # operates on mat(arg)
    nargs: int = 1
    # the epigraph's t is per coordinate (same size as x), not one bound
    elementwise_epi: bool = False
    # warm-startable kernels: stateful_prox(v, lam, state, **p) -> (x, state)
    # with state_init(dim, dtype) the cold start
    stateful_prox: Optional[Callable] = None
    state_init: Optional[Callable] = None
    capturable: bool = False


def _scaled_zone_entry(defaults, capturable=False):
    def prox(v, lam, **p):
        q = {**defaults, **p}
        return ew.prox_scaled_zone(v, lam, q["alpha"], q["beta"], q["C"], q["M"])

    def epi(v, s, **p):
        q = {**defaults, **p}
        return ew.epi_scaled_zone(v, s, q["alpha"], q["beta"], q["C"], q["M"])

    def feval(x, **p):
        q = {**defaults, **p}
        return ew.eval_scaled_zone(x, q["alpha"], q["beta"], q["C"], q["M"])

    return KernelEntry(prox=prox, epi=epi, feval=feval, elementwise=True,
                       capturable=capturable)


def _epi_sum_square(v, s):
    """Project every row's (v, s) onto {(x, t): ||x||^2 <= t}: the plain
    version (:func:`_epi_sum_square_reference`) on a CPU tensor, one launch
    of the ``epi_sum_square`` kernel on a CUDA tensor; any other device
    raises."""
    if v.device.type == "cpu":
        return _epi_sum_square_reference(v, s)
    return epi_sum_square.epi_rows(v, s)


def _epi_sum_square_reference(v, s):
    """Project (v, s) onto {(x, t): ||x||^2 <= t}: lam >= max(0, -s) solves
    the cubic (s + lam)(1 + 2 lam)^2 = ||v||^2, then x = v/(1+2 lam),
    t = s + lam; increasing on the bracket, so safeguarded Newton."""
    s = as_tensor_like(s, v)
    u2 = torch.sum(v * v, dim=-1)

    def g(lam):
        return (s + lam) * (1.0 + 2.0 * lam) ** 2 - u2

    def gp(lam):
        return (1.0 + 2.0 * lam) * (1.0 + 6.0 * lam + 4.0 * s)

    lo = torch.clamp(-s, min=0.0)
    hi = lo + torch.sqrt(u2) + u2 + 1.0
    for _ in range(40):
        hi = torch.where(g(hi) < 0, 2 * hi, hi)
    lam = newton_safeguarded(g, gp, 0.5 * (lo + hi), lo, hi, iters=25)
    inactive = u2 <= s
    return (where_batch(inactive, v, v / (1.0 + 2.0 * lam[..., None])),
            torch.where(inactive, s, s + lam))


def _zero(x):
    return torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)


KERNELS: Dict[ProxKind, KernelEntry] = {
    ProxKind.SUM_SQUARE: KernelEntry(
        # canonical form (H = I); the general case uses the KKT operator
        prox=lambda v, lam, **p: v / (1.0 + 2.0 * lam),
        epi=lambda v, s, **p: _epi_sum_square(v, s),
        feval=lambda x, **p: torch.sum(x * x, dim=-1),
        elementwise=True),
    ProxKind.NON_NEGATIVE: KernelEntry(
        prox=lambda v, lam, **p: ew.prox_non_negative(v, lam),
        feval=lambda x, **p: _zero(x),
        elementwise=True),
    ProxKind.NORM_1: _scaled_zone_entry(dict(alpha=1.0, beta=1.0, C=0.0, M=0.0),
                                        capturable=True),
    ProxKind.SUM_DEADZONE: _scaled_zone_entry(dict(alpha=1.0, beta=1.0, C=0.0, M=0.0)),
    ProxKind.SUM_HINGE: _scaled_zone_entry(dict(alpha=1.0, beta=0.0, C=0.0, M=0.0)),
    ProxKind.SUM_QUANTILE: _scaled_zone_entry(dict(alpha=1.0, beta=1.0, C=0.0, M=0.0)),
    ProxKind.SUM_EXP: KernelEntry(
        prox=lambda v, lam, **p: ew.prox_sum_exp(v, lam),
        epi=ne.make_epigraph(ew.eval_sum_exp, torch.exp, fhess=torch.exp,
                             prox=ew.prox_sum_exp),
        feval=lambda x, **p: ew.eval_sum_exp(x),
        elementwise=True),
    ProxKind.EXP: KernelEntry(
        # only the epigraph form exists in the reference
        epi=lambda v, s, **p: ew.epi_exp(v, s),
        feval=lambda x, **p: torch.exp(x),
        elementwise=True, elementwise_epi=True),
    ProxKind.SUM_LOGISTIC: KernelEntry(
        prox=lambda v, lam, **p: ew.prox_sum_logistic(v, lam),
        epi=ne.make_epigraph(
            ew.eval_sum_logistic, torch.sigmoid,
            fhess=lambda x: torch.sigmoid(x) * (1.0 - torch.sigmoid(x)),
            prox=ew.prox_sum_logistic),
        feval=lambda x, **p: ew.eval_sum_logistic(x),
        elementwise=True),
    ProxKind.SUM_INV_POS: KernelEntry(
        prox=lambda v, lam, **p: ew.prox_sum_inv_pos(v, lam),
        epi=ne.make_epigraph(
            ew.eval_sum_inv_pos,
            lambda x: -1.0 / (x * x),
            fhess=lambda x: 2.0 / (x * x * x),
            proj=lambda x: torch.clamp(x, min=1e-6),
            dom=lambda v: torch.all(v > 0, dim=-1),
            prox=ew.prox_sum_inv_pos),
        feval=lambda x, **p: ew.eval_sum_inv_pos(x),
        elementwise=True),
    ProxKind.SUM_NEG_ENTR: KernelEntry(
        prox=lambda v, lam, **p: ew.prox_sum_neg_entr(v, lam),
        epi=ne.make_epigraph(
            ew.eval_sum_neg_entr,
            lambda x: torch.log(x) + 1.0,
            fhess=lambda x: 1.0 / x,
            proj=lambda x: torch.clamp(x, min=1e-12),
            dom=lambda v: torch.all(v >= 0, dim=-1),
            prox=ew.prox_sum_neg_entr),
        feval=lambda x, **p: ew.eval_sum_neg_entr(x),
        elementwise=True),
    ProxKind.SUM_NEG_LOG: KernelEntry(
        prox=lambda v, lam, **p: ew.prox_sum_neg_log(v, lam),
        epi=lambda v, s, **p: ew.epi_sum_neg_log(v, s),
        feval=lambda x, **p: ew.eval_sum_neg_log(x),
        elementwise=True),
    ProxKind.SUM_KL_DIV: KernelEntry(
        prox=lambda v, lam, **p: ew.prox_sum_kl_div(v[0], v[1], lam),
        epi=lambda v, s, **p: ew.epi_sum_kl_div(v[0], v[1], s),
        feval=lambda x, **p: ew.eval_sum_kl_div(x[0], x[1]),
        elementwise=True, nargs=2),
    # vector family ------------------------------------------------------
    ProxKind.MAX: KernelEntry(
        prox=lambda v, lam, **p: vec.prox_max(v, lam),
        epi=lambda v, s, **p: vec.epi_max(v, s),
        feval=lambda x, **p: vec.eval_max(x)),
    ProxKind.SUM_LARGEST: KernelEntry(
        prox=lambda v, lam, **p: vec.prox_sum_largest(v, lam, p["k"]),
        feval=lambda x, **p: vec.eval_sum_largest(x, p["k"])),
    ProxKind.NORM_2: KernelEntry(
        prox=lambda v, lam, **p: vec.prox_norm2(v, lam),
        epi=lambda v, s, **p: vec.epi_norm2(v, s),
        feval=lambda x, **p: vec.eval_norm2(x)),
    ProxKind.NORM_INF: KernelEntry(
        prox=lambda v, lam, **p: vec.prox_norm_inf(v, lam),
        epi=lambda v, s, **p: vec.epi_norm_inf(v, s),
        feval=lambda x, **p: vec.eval_norm_inf(x)),
    ProxKind.LOG_SUM_EXP: KernelEntry(
        prox=lambda v, lam, **p: vec.prox_log_sum_exp(v, lam),
        epi=lambda v, s, **p: vec.epi_log_sum_exp(v, s),
        feval=lambda x, **p: vec.eval_log_sum_exp(x)),
    ProxKind.TOTAL_VARIATION_1D: KernelEntry(
        prox=lambda v, lam, **p: tv1d.prox_tv1d_registry(v, lam),
        feval=lambda x, **p: tv1d.eval_tv1d(x),
        stateful_prox=lambda v, lam, st, **p:
            tv1d.prox_tv1d_registry_warm(v, lam, st),
        state_init=tv1d.tv1d_state_init),
    # matrix family ------------------------------------------------------
    ProxKind.SEMIDEFINITE: KernelEntry(
        prox=lambda V, lam, **p: mx.prox_semidefinite(V, lam),
        feval=lambda X, **p: torch.zeros(X.shape[:-2], dtype=X.dtype, device=X.device),
        matrix=True),
    ProxKind.NEG_LOG_DET: KernelEntry(
        prox=lambda V, lam, **p: mx.prox_neg_log_det(V, lam),
        epi=lambda V, s, **p: mx.epi_neg_log_det(V, s),
        feval=lambda X, **p: mx.eval_neg_log_det(X),
        matrix=True),
    ProxKind.NORM_NUCLEAR: KernelEntry(
        prox=lambda V, lam, **p: mx.prox_norm_nuclear(V, lam),
        epi=lambda V, s, **p: mx.epi_norm_nuclear(V, s),
        feval=lambda X, **p: mx.eval_norm_nuclear(X),
        matrix=True),
    ProxKind.LAMBDA_MAX: KernelEntry(
        prox=lambda V, lam, **p: mx.prox_lambda_max(V, lam),
        epi=lambda V, s, **p: mx.epi_lambda_max(V, s),
        feval=lambda X, **p: mx.eval_lambda_max(X),
        matrix=True),
    ProxKind.SIGMA_MAX: KernelEntry(
        prox=lambda V, lam, **p: mx.prox_sigma_max(V, lam),
        epi=lambda V, s, **p: mx.epi_sigma_max(V, s),
        feval=lambda X, **p: mx.eval_sigma_max(X),
        matrix=True),
}


def kernel_params(spec) -> Dict:
    """The keyword parameters of a spec's kernel calls; per-coordinate
    values (SUM_QUANTILE's alpha and beta) as tensors on the device."""
    from ..linop import to_tensor
    p = {k: (to_tensor(v) if hasattr(v, "shape") else v)
         for k, v in (spec.scaled_zone_params or {}).items()}
    if spec.k is not None:
        p["k"] = spec.k
    return p


def get_kernel(kind: ProxKind) -> KernelEntry:
    try:
        return KERNELS[kind]
    except KeyError:
        raise NotImplementedError(f"no canonical kernel for {kind}") from None


def epigraph_via_bisection(kind: ProxKind):
    """Fallback epigraph: outer bisection over the kernel's own prox and
    value (for kinds without a dedicated epigraph kernel)."""
    from .util import implicit_epigraph
    entry = get_kernel(kind)

    def epi(v, s, **p):
        return implicit_epigraph(
            lambda vv, lam: entry.prox(vv, lam, **p),
            lambda xx: entry.feval(xx, **p), v, s)

    return epi
