"""The SUM_LOGISTIC prox as one kernel launch (``csrc/sum_logistic.cu``):
``x + lam sigmoid(x) = v`` for every element, one thread an element.

The JAX package compiles ``prox_sum_logistic``
(``epsilon_tpu/ops/prox/elementwise.py``), its 40-step safeguarded Newton
(``util.newton_safeguarded``, a ``lax.fori_loop``) included, into one
device program per call.  The port's plain version
(:func:`~epsilon_tpu_torch.ops.prox.elementwise.prox_sum_logistic_reference`)
issues every step as eager operations.

This is the kernel entry: it takes CUDA tensors only and raises on any
other device.  The dispatch (the plain version on a CPU tensor) is in
``ops/prox/elementwise.py``.  The kernel's loop stops once its state
repeats, which gives the full-count result bitwise; :func:`prox_full`
launches the build that runs the loop to its count, the reference that
exit is checked against (no dispatch calls it).  ``steps``, where given,
receives each element's Newton steps.  A launch spreads its elements over
every SM (:func:`threads`).
"""

from __future__ import annotations

import ctypes

import torch

from . import _rows

__all__ = ["prox", "prox_full", "build", "entries", "threads", "launches", "STEPS"]

# Kernel launches made by prox (the full-count build's are not counted).
launches = 0

# The safeguarded Newton's count (the JAX package's).
STEPS = 40

_LIB = None


def build():
    """Compile ``csrc/sum_logistic.cu``; returns ``(path, seconds, log)``."""
    return _rows.build("sum_logistic")


def entries():
    """The C entries of ``csrc/sum_logistic.cu`` and their argument types
    (``_rows.load``'s form)."""
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    out = {f"sum_logistic_prox_{build}{t}": [P, P, I, "scalar", P, P, L, P]
           for build in ("", "full_") for t in ("f32", "f64")}
    out["sum_logistic_threads"] = [L]
    return out


def _library():
    global _LIB
    if _LIB is None:
        _LIB = _rows.load("sum_logistic", entries())
    return _LIB


def threads(n: int) -> int:
    """The threads a block of a launch of n elements on the current CUDA
    device (``row_loops.cuh`` ``element_threads``: the launch spread over
    every SM, 32-256)."""
    return int(_library().sum_logistic_threads(n))


def _prox(fname, build, v, lam, steps):
    v, ptr, stride, value, _keep = _rows.element_args(fname, "lam", v, lam)
    x = torch.empty_like(v)
    steps_ptr = _rows.element_steps_ptr(fname, steps, x.shape, x.device)
    fn = getattr(_library(), f"sum_logistic_prox_{build}{_rows.suffix(x)}")
    if not build:
        global launches
        launches += 1
    _rows.launch(fname, fn, (v.data_ptr(), ptr, stride, value, x.data_ptr(), steps_ptr,
                             x.numel()), x)
    return x


def prox(v, lam, steps=None):
    """``x`` with ``x + lam sigmoid(x) = v`` elementwise (CUDA, f32 or f64);
    ``lam`` a number, a one-element tensor (on v's device it is read there,
    never on the host) or a tensor broadcasting with v.  One launch."""
    return _prox("sum_logistic", "", v, lam, steps)


def prox_full(v, lam, steps=None):
    """:func:`prox` by the full-count build (uncounted)."""
    return _prox("sum_logistic full", "full_", v, lam, steps)
