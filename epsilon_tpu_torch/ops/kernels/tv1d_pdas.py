"""The TV-1D prox by PDAS as one cooperative kernel launch
(``csrc/tv1d_pdas.cu``): every round of the primal-dual active-set loop,
its PCR solve and its stop test on the device, with no host sync between
rounds.

The JAX package compiles ``prox_tv1d_pdas`` (``epsilon_tpu/ops/prox/tv1d.py``,
one ``lax.while_loop``) into one device program.  The port's plain version
(:func:`~epsilon_tpu_torch.ops.prox.tv1d.prox_tv1d_pdas_reference`) issues
each round as eager operations and reads its stop test back to the host.

These are the kernel entries: they take CUDA tensors only and raise on any
other device.  The dispatch (the plain version on a CPU tensor) is in
``ops/prox/tv1d.py``.  :func:`pcr` runs one PCR solve alone, the same
device code as the PDAS's (uncounted; it is checked bitwise against the
plain ``pcr_tridiag_solve``).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _rows

__all__ = ["pdas", "pcr", "pcr_steps", "grid", "threads", "build", "launches"]

# Kernel launches made by pdas (pcr's are not counted).
launches = 0

_LIB = None
_GRIDS = {}


def build():
    """Compile ``csrc/tv1d_pdas.cu``; returns ``(path, seconds, log)``."""
    return _rows.build("tv1d_pdas")


def _library():
    global _LIB
    if _LIB is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        entries = {"tv1d_pdas_threads": []}
        for t in ("f32", "f64"):
            entries[f"tv1d_pdas_{t}"] = [P, P, P, "scalar", "scalar", I, I, I, P, P, P, P,
                                         P, P, P, I, P]
            entries[f"tv1d_pcr_{t}"] = [P, P, P, P, P, I, I, P, I, P]
            entries[f"tv1d_pdas_grid_{t}"] = [I]
            entries[f"tv1d_pcr_grid_{t}"] = [I]
        _LIB = _rows.load("tv1d_pdas", entries)
    return _LIB


def pcr_steps(m: int) -> int:
    """The PCR steps of a system of m rows (``pcr_tridiag_solve``'s count)."""
    return max(1, int(np.ceil(np.log2(max(m, 2)))))


def threads() -> int:
    """Threads a block of the kernels."""
    return _library().tv1d_pdas_threads()


def grid(entry: str, length: int, t: torch.Tensor) -> int:
    """The blocks of a launch of ``entry`` (``"pdas"`` or ``"pcr"``) over
    ``length`` elements of t's dtype on t's device: the blocks the card
    keeps resident, or the row's, whichever is fewer."""
    key = (entry, length, t.dtype, t.device)
    if key not in _GRIDS:
        with torch.cuda.device(t.device):
            g = getattr(_library(), f"tv1d_{entry}_grid_{_rows.suffix(t)}")(length)
        if g <= 0:
            raise RuntimeError(f"tv1d_{entry}: the occupancy query failed on {t.device}")
        _GRIDS[key] = g
    return _GRIDS[key]


def _vector(fname, name, a, n=None):
    if not isinstance(a, torch.Tensor):
        raise TypeError(f"{fname}: {name} must be a tensor, got {type(a).__name__}")
    if a.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{fname}: {name} must be float32 or float64, got {a.dtype}")
    if a.device.type != "cuda":
        raise ValueError(f"{fname}: the kernel needs a CUDA tensor, got one on {a.device}")
    if a.dim() != 1 or (n is not None and a.shape[0] != n):
        want = "a vector" if n is None else f"a vector of {n}"
        raise ValueError(f"{fname}: {name} {tuple(a.shape)} must be {want}")
    if a.shape[0] >= 2 ** 31 - 1:
        raise ValueError(f"{fname}: {name} {tuple(a.shape)} is too large")
    return a.contiguous()


def pdas(v, lam, tol: float, max_iters: int = 40, z0=None):
    """The TV-1D prox of the vector v (CUDA, f32 or f64, n >= 2) by PDAS
    at the gap tolerance ``tol`` (``tv1d.tv_gap_tol``), at most
    ``max_iters`` rounds, from the dual ``z0`` (n - 1, clamped into the
    box) or from 0; ``lam`` a number or a one-element tensor (on v's device
    it is read there, never on the host).  Returns ``(x, z, gap, rounds)``,
    gap a 0-d tensor of v's dtype and rounds a 0-d int32 tensor, all on v's
    device.  One launch."""
    fname = "tv1d_pdas"
    v = _vector(fname, "v", v)
    n = v.shape[0]
    if n < 2:
        raise ValueError(f"{fname}: v {tuple(v.shape)} needs at least two elements")
    m = n - 1
    lam_ptr, lam_value, keep = None, 0.0, None
    if isinstance(lam, torch.Tensor):
        if lam.numel() != 1:
            raise ValueError(f"{fname}: lam {tuple(lam.shape)} must be one value")
        if lam.device.type == "cpu":
            lam_value = float(lam.reshape(()))
        elif lam.device != v.device:
            raise ValueError(f"{fname}: lam on {lam.device}, v on {v.device}")
        else:
            keep = lam.reshape(()).to(v.dtype)
            lam_ptr = keep.data_ptr()
    else:
        lam_value = float(lam)
    z0_ptr = None
    if z0 is not None:
        if not isinstance(z0, torch.Tensor) or z0.device != v.device:
            raise ValueError(f"{fname}: z0 must be a tensor on {v.device}")
        z0 = _vector(fname, "z0", z0.to(v.dtype), m)
        z0_ptr = z0.data_ptr()
    g = grid("pdas", n, v)
    x = torch.empty_like(v)
    z = torch.empty(m, dtype=v.dtype, device=v.device)
    gap = torch.empty((), dtype=v.dtype, device=v.device)
    rounds = torch.empty((), dtype=torch.int32, device=v.device)
    scratch = torch.empty(12 * m + 16 * g, dtype=v.dtype, device=v.device)
    act = torch.empty(m, dtype=torch.int8, device=v.device)
    flags = torch.empty(2 * g, dtype=torch.int32, device=v.device)
    fn = getattr(_library(), f"tv1d_pdas_{_rows.suffix(v)}")
    global launches
    launches += 1
    _rows.launch(fname, fn, (v.data_ptr(), z0_ptr, lam_ptr, lam_value, float(tol), n,
                             int(max_iters), pcr_steps(m), x.data_ptr(), z.data_ptr(),
                             gap.data_ptr(), rounds.data_ptr(), scratch.data_ptr(),
                             act.data_ptr(), flags.data_ptr(), g), v)
    return x, z, gap, rounds


def pcr(a, b, c, d):
    """``pcr_tridiag_solve(a, b, c, d)`` for vectors on the card (f32 or
    f64) by the PDAS kernel's PCR code in one cooperative launch
    (uncounted)."""
    fname = "tv1d_pcr"
    a = _vector(fname, "a", a)
    m = a.shape[0]
    if m < 1:
        raise ValueError(f"{fname}: the system needs at least one row")
    b, c, d = (_vector(fname, name, t, m) for name, t in (("b", b), ("c", c), ("d", d)))
    if not all(t.dtype == a.dtype and t.device == a.device for t in (b, c, d)):
        raise ValueError(f"{fname}: a, b, c and d must share a dtype and a device")
    g = grid("pcr", m, a)
    out = torch.empty_like(a)
    scratch = torch.empty(8 * m, dtype=a.dtype, device=a.device)
    fn = getattr(_library(), f"tv1d_pcr_{_rows.suffix(a)}")
    _rows.launch(fname, fn, (a.data_ptr(), b.data_ptr(), c.data_ptr(), d.data_ptr(),
                             out.data_ptr(), m, pcr_steps(m), scratch.data_ptr(), g), a)
    return out
