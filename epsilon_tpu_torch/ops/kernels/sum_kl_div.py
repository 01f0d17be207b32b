"""The SUM_KL_DIV prox as one kernel launch (``csrc/sum_kl_div.cu``): for
``f(x, y) = x log(x/y) - x + y``, the prox of ``(u, v)`` with weight
``lam`` for every element, one thread an element.

The JAX package compiles ``prox_sum_kl_div``
(``epsilon_tpu/ops/prox/elementwise.py``), its 60-step widening of the
bracket (a ``lax.fori_loop``) and its 60-step safeguarded Newton
(``util.newton_safeguarded``) included, into one device program per call.
The port's plain version
(:func:`~epsilon_tpu_torch.ops.prox.elementwise.prox_sum_kl_div_reference`)
issues every step as eager operations.

This is the kernel entry: it takes CUDA tensors only and raises on any
other device.  The dispatch (the plain version on a CPU tensor) is in
``ops/prox/elementwise.py``.  The kernel's widening stops at its first step
that leaves the bracket's end unchanged, which gives the full-count result
bitwise, and its Newton runs its count (an exit there measured slower:
the source's note); :func:`prox_full` launches the build that runs both
loops to their counts, the reference the widening's exit is checked
against (no dispatch calls it).  ``steps``, where
given, receives each element's widening and Newton steps.  u, v and lam
are read where they lie when their elements form rows with one row stride
(views of one packed tensor, as the two-argument family and the KL
epigraph pass u and v; lam one a row, as the epigraph passes it;
``_rows.element_args2``).
"""

from __future__ import annotations

import ctypes

import torch

from . import _rows

__all__ = ["prox", "prox_full", "build", "entries", "launches", "WIDEN_STEPS",
           "NEWTON_STEPS"]

# Kernel launches made by prox (the full-count build's are not counted).
launches = 0

# The loops' counts (the JAX package's): the bracket's widening, then the
# safeguarded Newton.
WIDEN_STEPS = 60
NEWTON_STEPS = 60

_LIB = None


def build():
    """Compile ``csrc/sum_kl_div.cu``; returns ``(path, seconds, log)``."""
    return _rows.build("sum_kl_div")


def entries():
    """The C entries of ``csrc/sum_kl_div.cu`` and their argument types
    (``_rows.load``'s form)."""
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    return {f"sum_kl_div_prox_{build}{t}": [P, L, L, P, L, L, L, P, L, L, "scalar", P, P, P, L, P]
            for build in ("", "full_") for t in ("f32", "f64")}


def _library():
    global _LIB
    if _LIB is None:
        _LIB = _rows.load("sum_kl_div", entries())
    return _LIB


def _prox(fname, build, u, v, lam, steps):
    (u, v), n, shape, lam, _keep = _rows.element_args2(fname, "lam", u, v, lam)
    x = torch.empty(shape, dtype=v[0].dtype, device=v[0].device)
    y = torch.empty_like(x)
    steps_ptr = _rows.element_steps_ptr(fname, steps, shape + (2,), x.device)
    fn = getattr(_library(), f"sum_kl_div_prox_{build}{_rows.suffix(x)}")
    if not build:
        global launches
        launches += 1
    _rows.launch(fname, fn, (u[0].data_ptr(), *u[1:], v[0].data_ptr(), *v[1:], n, *lam,
                             x.data_ptr(), y.data_ptr(), steps_ptr, x.numel()), x)
    return x, y


def prox(u, v, lam, steps=None):
    """``(x, y)``, the SUM_KL_DIV prox of ``(u, v)`` elementwise (CUDA, f32
    or f64, u and v of one dtype broadcasting together); ``lam`` a number,
    a one-element tensor (on the card it is read there, never on the host)
    or a tensor broadcasting with them (a stacked row's ``(rows, 1)``
    included).  ``steps``, an int32 tensor of the joint shape + ``(2,)``,
    receives each element's widening and Newton steps.  One launch."""
    return _prox("sum_kl_div", "", u, v, lam, steps)


def prox_full(u, v, lam, steps=None):
    """:func:`prox` by the full-count build (uncounted)."""
    return _prox("sum_kl_div full", "full_", u, v, lam, steps)
