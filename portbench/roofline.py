"""The yardstick of a kernel's roofline share: the card's published peaks,
the least-time arithmetic, and the work each measured prox needs, counted
from its shapes.

Peaks and :func:`bound_s` are copied from the port's bring-up check
(``chip_smoke.py`` ``PEAK_*`` and ``bound()``): one NVIDIA H100 SXM at its
700 W limit, 3.35 TB/s of HBM3, 67 TFLOP/s in float32 outside the tensor
cores and in float64 on them.
"""

from __future__ import annotations

import re

PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "float64": 67e12}
ITEMSIZE = {"float32": 4, "float64": 8}

# K7, the TV-1D PDAS, one cooperative launch a call: its dispatched build
# and the build kept as its yardstick (``csrc/tv1d_pdas.cu``).
K7_KERNELS = ("pdas_tiles", "pdas_levels")


def is_kernel(name: str, kernels) -> bool:
    """Whether a device operation's (demangled) name is one of ``kernels``:
    ``void (anonymous namespace)::pdas_tiles<float>(...)`` is ``pdas_tiles``."""
    return any(re.search(rf"(?<![\w]){k}\s*[<(]", name) for k in kernels)


def bound_s(n_bytes: float, ops: float, dtype: str) -> float:
    """The least seconds the card could take: the larger of the bytes over
    its bandwidth and the operations over its peak rate."""
    return max(n_bytes / PEAK_BYTES_PER_S, ops / PEAK_FLOPS[dtype])


def tv1d_prox_work(n: int, dtype: str):
    """``(bytes, operations)`` of one TV-1D prox of n samples,
    argmin_x 1/2 ||x - v||^2 + lam tv(x): v read once and x written once;
    6 operations a sample, the direct algorithm's common step (two
    differences, two running sums, two comparisons against the tube).
    The bytes bound it (by 28x in float32)."""
    return 2 * n * ITEMSIZE[dtype], 6 * n
