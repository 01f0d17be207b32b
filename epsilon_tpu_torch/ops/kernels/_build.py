"""Build a kernel source of ``csrc/`` into a shared library for ctypes.

Each kernel is one ``csrc/<name>.cu`` with a plain C interface (it may
include the shared ``csrc/*.cuh`` headers).  It is compiled with ``nvcc``
for ``sm_90a`` at first use into ``build/kernels/lib<name>_<sha>.so``,
named by the hash of the source, the headers and the flags, so that an
edit rebuilds.  Separate sources build independently, so callers may start
several builds at once.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

__all__ = ["build"]

_CSRC = Path(__file__).resolve().parents[2] / "csrc"
_BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the port's CUDA kernels need the CUDA toolkit")
    return found


def build(name: str, flags=(), csrc=None):
    """Compile ``csrc/<name>.cu`` for sm_90a, with the extra nvcc ``flags``,
    into a shared library under ``build/kernels/``; ``csrc``, where given,
    is another tree's kernel directory (``tools/profile_port.py --k6``
    builds an earlier tree's kernel beside this one's).  Returns ``(path,
    seconds, compiler_log)``; seconds is 0 when the library was already
    built."""
    csrc = _CSRC if csrc is None else Path(csrc)
    src = csrc / f"{name}.cu"
    digest = hashlib.sha1(src.read_bytes())
    for header in sorted(csrc.glob("*.cuh")):
        digest.update(header.read_bytes())
    digest.update(" ".join(flags).encode())
    out = _BUILD_DIR / f"lib{name}_{digest.hexdigest()[:12]}.so"
    log = out.with_name(f"{out.name}.log")
    if out.exists():
        return out, 0.0, log.read_text() if log.exists() else ""
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # two threads may build the same library at once: each writes its own
    # file and the later replace wins
    tmp = out.with_name(f"{out.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
           "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", *flags,
           "-o", str(tmp), str(src)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src.name} (exit {proc.returncode}):\n"
                           f"{proc.stdout}\n{proc.stderr}")
    text = proc.stdout + proc.stderr
    log.write_text(text)
    os.replace(tmp, out)
    return out, time.perf_counter() - t0, text
