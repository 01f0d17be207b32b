"""Canonical prox kernel registry.

Counterpart of ``epsilon_tpu/ops/prox/registry.py``: maps each
:class:`~epsilon_tpu_torch.ir.ProxKind` to its canonical-form kernels,

- ``prox(v, lam, **params) -> x``  solving argmin f(x) + ||x-v||^2/(2*lam)
- ``feval(x, **params) -> f(x)``   function value

So far only NORM_1 is ported; every other kind raises.  The epigraph
projections and the warm-started (stateful) kernels come with the kinds
that need them.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

from ...ir import ProxKind
from . import elementwise as ew


@dataclasses.dataclass
class KernelEntry:
    prox: Optional[Callable] = None
    feval: Optional[Callable] = None
    elementwise: bool = False   # supports vector lam
    matrix: bool = False        # operates on mat(arg)
    nargs: int = 1


def _scaled_zone_entry(defaults):
    def prox(v, lam, **p):
        q = {**defaults, **p}
        return ew.prox_scaled_zone(v, lam, q["alpha"], q["beta"], q["C"], q["M"])

    def feval(x, **p):
        q = {**defaults, **p}
        return ew.eval_scaled_zone(x, q["alpha"], q["beta"], q["C"], q["M"])

    # the epigraph projection (epi_scaled_zone, a piecewise-linear root
    # search) is not yet ported
    return KernelEntry(prox=prox, feval=feval, elementwise=True)


KERNELS: Dict[ProxKind, KernelEntry] = {
    ProxKind.NORM_1: _scaled_zone_entry(dict(alpha=1.0, beta=1.0, C=0.0, M=0.0)),
}


def get_kernel(kind: ProxKind) -> KernelEntry:
    try:
        return KERNELS[kind]
    except KeyError:
        raise NotImplementedError(
            f"the {kind.value} prox kernel is not yet ported") from None
