"""Exact 1-D total-variation denoising: argmin_x 1/2 ||x - v||^2 + lam tv(x).

A frozen copy of Condat's direct algorithm (L. Condat, "A direct algorithm
for 1-D total variation denoising", IEEE SPL 20(11), 2013), as the port
keeps it for its tests (``epsilon_tpu_torch/ops/prox/tv1d.py``
``tv1d_exact_numpy``), rewritten on Python floats so that one pass over
10^6 samples takes seconds, and with every arithmetic result passed through
``q``: the identity for the float64 reference, a rounding to a narrower
format for the precision control (:func:`round_bf16`).
"""

from __future__ import annotations

import math

import numpy as np


def round_bf16(x: float) -> float:
    """``x`` rounded to the nearest bfloat16 (8 significant bits, ties to
    even), kept as a Python float."""
    if x == 0.0 or not math.isfinite(x):
        return x
    m, e = math.frexp(x)
    return math.ldexp(round(m * 256.0) / 256.0, e)


def _same(x: float) -> float:
    return x


def tv1d_exact(v, lam: float, q=None) -> np.ndarray:
    """The exact minimiser, float64 (``q`` None), or computed with every
    operation rounded by ``q``."""
    q = q or _same
    v = [q(float(t)) for t in np.asarray(v, dtype=np.float64).ravel()]
    n = len(v)
    if n <= 1 or lam <= 0:
        return np.asarray(v, dtype=np.float64)
    lam = q(float(lam))
    twolam = q(2.0 * lam)
    x = [0.0] * n
    k = k0 = kminus = kplus = 0
    vmin = q(v[0] - lam)
    vmax = q(v[0] + lam)
    umin = lam
    umax = -lam
    while True:
        if k == n - 1:
            if umin < 0.0:
                x[k0:kminus + 1] = [vmin] * (kminus + 1 - k0)
                k = k0 = kminus = kminus + 1
                vmin = v[k]
                umin = lam
                umax = q(q(vmin + lam) - vmax)
            elif umax > 0.0:
                x[k0:kplus + 1] = [vmax] * (kplus + 1 - k0)
                k = k0 = kplus = kplus + 1
                vmax = v[k]
                umax = -lam
                umin = q(q(vmax - lam) - vmin)
            else:
                x[k0:] = [q(vmin + q(umin / (k - k0 + 1)))] * (n - k0)
                return np.asarray(x, dtype=np.float64)
            if k == n - 1:
                x[k] = q(vmin + umin)
                return np.asarray(x, dtype=np.float64)
            continue
        vk1 = v[k + 1]
        if q(vk1 + umin) < q(vmin - lam):
            # negative jump: the minorant breaks
            x[k0:kminus + 1] = [vmin] * (kminus + 1 - k0)
            k = k0 = kminus = kplus = kminus + 1
            vmin = v[k]
            vmax = q(v[k] + twolam)
            umin = lam
            umax = -lam
        elif q(vk1 + umax) > q(vmax + lam):
            # positive jump: the majorant breaks
            x[k0:kplus + 1] = [vmax] * (kplus + 1 - k0)
            k = k0 = kminus = kplus = kplus + 1
            vmin = q(v[k] - twolam)
            vmax = v[k]
            umin = lam
            umax = -lam
        else:
            k += 1
            umin = q(umin + q(vk1 - vmin))
            umax = q(umax + q(vk1 - vmax))
            if umin >= lam:
                vmin = q(vmin + q(q(umin - lam) / (k - k0 + 1)))
                umin = lam
                kminus = k
            if umax <= -lam:
                vmax = q(vmax + q(q(umax + lam) / (k - k0 + 1)))
                umax = -lam
                kplus = k
