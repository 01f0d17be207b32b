"""Fused consensus local update over the leading block axis.

Hand-written CUDA counterpart of the Pallas TPU kernel ``fused_local_update``
(``epsilon_tpu/ops/pallas_kernels.py``, kernel body ``_make_kernel._kernel``).
For each scenario block s::

    x_s    = Finv_s (Atb_s + rho (z - u_s))
    xu_sum = sum_s (x_s + u_s)

The update is bound by device memory: it streams each block's n x n inverse
once per iteration, S n^2 elements.  The kernel (``csrc/local_update.cu``)
reads each element once: pass 1, one block per (block s, 32 rows), stages
``rhs_s`` in shared memory and reduces each row's dot product across a warp;
pass 2 sums ``x + u`` over the blocks in a fixed order.  No float atomics,
so results repeat bitwise.  rho is a runtime argument: a new rho does not
rebuild anything.

On a CPU tensor :func:`fused_local_update` runs the plain PyTorch version
:func:`local_update_reference`; on a CUDA tensor it launches the kernel or
raises.  The library is compiled with ``nvcc`` at first use from the
package's own source into ``build/kernels/`` and loaded with ``ctypes``.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = ["fused_local_update", "local_update_reference", "local_update_supported",
           "build", "launches"]

# Kernel launches made by fused_local_update (CUDA tensors only).
launches = 0

_LIB = None


def local_update_reference(Finv, Atb, u, z, rho):
    """Plain PyTorch version: ``x`` (S, n) and ``sum(x + u)`` (n,)."""
    rhs = Atb + rho * (z[None, :] - u)
    x = torch.bmm(Finv, rhs.unsqueeze(-1)).squeeze(-1)
    return x, torch.sum(x + u, dim=0)


def local_update_supported(S: int, n: int) -> bool:
    """The JAX package's gate (``pallas_supported``): the fused kernel from
    n = 128, so that the port takes the same branches."""
    return n >= 128


def build():
    """Compile ``csrc/local_update.cu`` (see :func:`._build.build`).
    Returns ``(path, seconds, compiler_log)``."""
    return _build.build("local_update")


def _library():
    global _LIB
    if _LIB is None:
        path, _, _ = build()
        lib = ctypes.CDLL(str(path))
        for name in ("local_update_f32", "local_update_f64"):
            fn = getattr(lib, name)
            fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_double]
                           + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2 + [ctypes.c_void_p])
            fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def _check_cuda_args(Finv, Atb, u, z):
    dev = Finv.device
    for name, t in (("Finv", Finv), ("Atb", Atb), ("u", u), ("z", z)):
        if t.device != dev:
            raise ValueError(f"fused_local_update: {name} on {t.device}, Finv on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"fused_local_update: {name} must be contiguous")
        if t.dtype != Finv.dtype:
            raise TypeError(f"fused_local_update: {name} is {t.dtype}, Finv {Finv.dtype}")
    if Finv.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"fused_local_update: {Finv.dtype} is not float32 or float64")
    if Finv.dim() != 3 or Finv.shape[1] != Finv.shape[2]:
        raise ValueError(f"fused_local_update: Finv {tuple(Finv.shape)} must be (S, n, n)")
    S, n, _ = Finv.shape
    if S < 1 or n < 1 or S >= 2 ** 31 or n >= 2 ** 31:
        raise ValueError(f"fused_local_update: S={S}, n={n} out of range")
    for name, t, shape in (("Atb", Atb, (S, n)), ("u", u, (S, n)), ("z", z, (n,))):
        if tuple(t.shape) != shape:
            raise ValueError(f"fused_local_update: {name} {tuple(t.shape)} must be {shape}")


def fused_local_update(Finv, Atb, u, z, rho):
    """Fused consensus local update.

    Args: Finv (S, n, n), Atb (S, n), u (S, n), z (n,), rho a Python float.
    Returns: x (S, n), xu_sum (n,).
    """
    if Finv.device.type == "cpu":
        return local_update_reference(Finv, Atb, u, z, rho)
    if Finv.device.type != "cuda":
        raise ValueError(f"fused_local_update: unsupported device {Finv.device}")
    _check_cuda_args(Finv, Atb, u, z)
    S, n, _ = Finv.shape
    fn = (_library().local_update_f32 if Finv.dtype == torch.float32
          else _library().local_update_f64)
    x = torch.empty_like(Atb)
    xu = torch.empty_like(z)
    global launches
    with torch.cuda.device(Finv.device):
        stream = torch.cuda.current_stream(Finv.device).cuda_stream
        launches += 1
        err = fn(Finv.data_ptr(), Atb.data_ptr(), u.data_ptr(), z.data_ptr(),
                 float(rho), x.data_ptr(), xu.data_ptr(), S, n, stream)
    if err != 0:
        raise RuntimeError(f"local_update kernel launch failed with CUDA error {err}")
    return x, xu
