"""Global configuration for the PyTorch port.

Counterpart of ``epsilon_tpu/config.py``.  The port runs on an explicit
device:

- ``"cuda"`` (the default): float32 state, the accelerator policy of the
  JAX package (``epsilon_tpu/config.py:3-10``).  With no CUDA device the
  default raises; it never falls back to the CPU.
- ``"cpu"`` (tests, chosen explicitly with :func:`set_device`): float64,
  matching the reference's accuracy envelope and the JAX tests' x64 mode.

Matmuls stay in full precision: the JAX package found that reduced-precision
passes make ADMM diverge (``epsilon_tpu/config.py:23-30``), so TF32 is off.
"""

from __future__ import annotations

import numpy as np
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

# Same thresholds as the JAX package, so the port takes the same branches.
SPARSE_DENSIFY_DENSITY = 0.01
SPARSE_DENSIFY_MAX_ELEMS = 64 * 1024 * 1024

# How cached factorizations apply their solves on the device:
#   "triangular" - LU triangular solves
#   "inverse"    - explicit inverse computed host-side in f64, applied as a
#                  dense matmul (or the packed symmetric kernel, see below)
#   "auto"       - "inverse" on CUDA, "triangular" on the CPU
# Read only by use_explicit_inverse(); ops.linop.LuFactorOp.apply_mode turns
# it into the apply of each factor.
FACTOR_SOLVE_MODE = "auto"

# From this dimension on, explicit-inverse symmetric factor applies stream the
# packed lower triangle through the sym_packed kernel (half the device
# memory traffic of a dense matvec; the apply is bandwidth-bound).
SYM_PACKED_MIN_DIM = 8192

_DEVICE = "cuda"

# Inner tolerance for iteratively certified prox kernels (TV-1D PDAS):
# None -> the dtype's default (ops/prox/tv1d.pdas_default_tol).  The solver
# sets it from its own rel_tol (prox_inner_tol_for), as the JAX package does,
# so both packages run the same PDAS rounds.
_PROX_INNER_TOL = None


def prox_inner_tol():
    return _PROX_INNER_TOL


def set_prox_inner_tol(tol):
    global _PROX_INNER_TOL
    _PROX_INNER_TOL = tol


def prox_inner_tol_for(rel_tol: float):
    """Inner certificate tolerance tied to an outer solver tolerance: one
    decade tighter than rel_tol, floored at the dtype's certifiable
    sqrt-precision (1e-7 f64 / 3e-4 f32)."""
    if rel_tol is None or rel_tol <= 0:
        return None
    from .ops.prox.tv1d import default_tv_tol  # local: avoids an import cycle
    return max(0.1 * rel_tol, default_tv_tol(default_dtype()))


def set_device(device) -> None:
    """Select the device every tensor of the port is created on."""
    global _DEVICE
    _DEVICE = str(torch.device(device))


def device() -> torch.device:
    dev = torch.device(_DEVICE)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "epsilon_tpu_torch: no CUDA device is available; select the CPU "
            "explicitly with epsilon_tpu_torch.config.set_device('cpu')")
    return dev


def on_cuda() -> bool:
    return device().type == "cuda"


def default_dtype() -> torch.dtype:
    """Float dtype of solver state and device constants."""
    return torch.float32 if on_cuda() else torch.float64


def default_np_dtype() -> np.dtype:
    return np.dtype(np.float32) if on_cuda() else np.dtype(np.float64)


def use_explicit_inverse() -> bool:
    if FACTOR_SOLVE_MODE == "inverse":
        return True
    if FACTOR_SOLVE_MODE == "triangular":
        return False
    return on_cuda()
