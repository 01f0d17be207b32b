"""The SUM_EXP and SUM_NEG_ENTR proxes as one kernel launch each
(``csrc/w_log_w.cu``), one thread an element: both solve ``w + log w =
c`` (``w = LambertW(e^c)``) by the 30-step Newton of ``row_loops.cuh``
``solve_w_log_w`` (the one K3's LOG_SUM_EXP kernels run).  SUM_EXP:
``x + lam e^x = v``, ``c = log(lam) + v``, ``x = v - w(c)``; SUM_NEG_ENTR:
``lam (log x + 1) + x = v``, ``c = (v - lam)/lam - log(lam)``, ``x = lam
w(c)``.

The JAX package compiles ``prox_sum_exp`` and ``prox_sum_neg_entr``
(``epsilon_tpu/ops/prox/elementwise.py``), the 30-step ``lax.fori_loop``
of ``util.solve_w_log_w`` included, into one device program per call.
The port's plain versions
(:func:`~epsilon_tpu_torch.ops.prox.elementwise.prox_sum_exp_reference`,
:func:`~epsilon_tpu_torch.ops.prox.elementwise.prox_sum_neg_entr_reference`)
issue every step as eager operations.

These are the kernel entries: they take CUDA tensors only and raise on any
other device.  The dispatch (the plain versions on a CPU tensor) is in
``ops/prox/elementwise.py``.  The solve stops once its state repeats,
which gives the full-count result bitwise; :func:`prox_exp_full` and
:func:`prox_neg_entr_full` launch the build that runs its 30 steps, the
reference that exit is checked against (no dispatch calls them).
``steps``, where given, receives each element's Lambert steps.
"""

from __future__ import annotations

import ctypes

import torch

from . import _rows

__all__ = ["prox_exp", "prox_exp_full", "prox_neg_entr", "prox_neg_entr_full", "build",
           "entries", "launches", "STEPS"]

# Kernel launches made by prox_exp and prox_neg_entr (the full-count
# builds' are not counted).
launches = 0

# The Lambert solve's count (the JAX package's).
STEPS = 30

_LIB = None


def build():
    """Compile ``csrc/w_log_w.cu``; returns ``(path, seconds, log)``."""
    return _rows.build("w_log_w")


def entries():
    """The C entries of ``csrc/w_log_w.cu`` and their argument types
    (``_rows.load``'s form)."""
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    return {f"w_log_w_{kind}_{build}{t}": [P, P, I, "scalar", P, P, L, P]
            for kind in ("exp", "neg_entr") for build in ("", "full_") for t in ("f32", "f64")}


def _library():
    global _LIB
    if _LIB is None:
        _LIB = _rows.load("w_log_w", entries())
    return _LIB


def _prox(fname, kind, build, v, lam, steps):
    v, ptr, stride, value, _keep = _rows.element_args(fname, "lam", v, lam)
    x = torch.empty_like(v)
    steps_ptr = _rows.element_steps_ptr(fname, steps, x.shape, x.device)
    fn = getattr(_library(), f"w_log_w_{kind}_{build}{_rows.suffix(x)}")
    if not build:
        global launches
        launches += 1
    _rows.launch(fname, fn, (v.data_ptr(), ptr, stride, value, x.data_ptr(), steps_ptr,
                             x.numel()), x)
    return x


def prox_exp(v, lam, steps=None):
    """The SUM_EXP prox, ``x + lam e^x = v`` elementwise (CUDA, f32 or f64);
    ``lam`` a number, a one-element tensor (on the card it is read there,
    never on the host) or a tensor broadcasting with v.  ``steps``, an int32
    tensor of the joint shape, receives each element's Lambert steps.  One
    launch."""
    return _prox("w_log_w exp", "exp", "", v, lam, steps)


def prox_exp_full(v, lam, steps=None):
    """:func:`prox_exp` by the full-count build (uncounted)."""
    return _prox("w_log_w exp full", "exp", "full_", v, lam, steps)


def prox_neg_entr(v, lam, steps=None):
    """The SUM_NEG_ENTR prox, ``lam (log x + 1) + x = v`` elementwise (as
    :func:`prox_exp`).  One launch."""
    return _prox("w_log_w neg_entr", "neg_entr", "", v, lam, steps)


def prox_neg_entr_full(v, lam, steps=None):
    """:func:`prox_neg_entr` by the full-count build (uncounted)."""
    return _prox("w_log_w neg_entr full", "neg_entr", "full_", v, lam, steps)
