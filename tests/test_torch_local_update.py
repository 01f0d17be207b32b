"""Port kernel K1 (fused_local_update): the port's wrapper on CPU tensors
(its plain PyTorch version) against the JAX package's
``local_update_reference`` and its Pallas kernel in interpret mode, the
n >= 128 gate and the wrapper's checks.  The CUDA kernel itself is tested in
test_torch_cuda.py.

Tolerances, relative to the largest reference value: 1e-12 in f64 and 1e-5
in f32 (the sums run in another order)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from epsilon_tpu.ops import pallas_kernels as pk
from epsilon_tpu_torch.ops.kernels import local_update as lu

RTOL = {np.float32: 1e-5, np.float64: 1e-12}


def _inputs(rng, S, n, dtype):
    A = rng.randn(S, 2 * n, n)
    Finv = np.linalg.inv(np.einsum("smi,smj->sij", A, A) + np.eye(n))
    return tuple(a.astype(dtype) for a in
                 (Finv, rng.randn(S, n), rng.randn(S, n), rng.randn(n)))


def _close(got, want, dtype):
    want = np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=RTOL[dtype] * np.abs(want).max())


@pytest.mark.parametrize("rho", [0.7, 2.5])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("S,n", [(4, 16), (1, 8), (3, 130)])
def test_matches_jax(rng, S, n, dtype, rho):
    args = _inputs(rng, S, n, dtype)
    x, xu = lu.fused_local_update(*map(torch.as_tensor, args), rho)
    x, xu = x.numpy(), xu.numpy()
    x_ref, xu_ref = pk.local_update_reference(*map(jnp.asarray, args), rho)
    _close(x, x_ref, dtype)
    _close(xu, xu_ref, dtype)
    if dtype == np.float32:
        # the Pallas kernel takes f32 only: its f32 dot cannot be stored into
        # an f64 output
        x_k, xu_k = pk.fused_local_update(*map(jnp.asarray, args), rho, interpret=True)
        _close(x, x_k, dtype)
        _close(xu, xu_k, dtype)


@pytest.mark.parametrize("n", [127, 128])
def test_gate_matches_pallas_supported(n):
    assert lu.local_update_supported(4, n) == pk.pallas_supported(4, n)


def _good(S=3, n=5, dtype=torch.float32):
    return dict(Finv=torch.zeros(S, n, n, dtype=dtype), Atb=torch.zeros(S, n, dtype=dtype),
                u=torch.zeros(S, n, dtype=dtype), z=torch.zeros(n, dtype=dtype))


@pytest.mark.parametrize("bad", [
    dict(z=torch.zeros(5, dtype=torch.float64)),                        # dtype mix
    dict(Finv=torch.zeros(3, 5, 5, dtype=torch.float16),
         Atb=torch.zeros(3, 5, dtype=torch.float16),
         u=torch.zeros(3, 5, dtype=torch.float16),
         z=torch.zeros(5, dtype=torch.float16)),                         # half
    dict(Finv=torch.zeros(3, 5, 4)),                                     # not square
    dict(Atb=torch.zeros(3, 6)),                                         # shape
    dict(z=torch.zeros(4)),                                              # shape
    dict(u=torch.zeros(5, 3).T),                                         # not contiguous
    dict(Finv=torch.zeros(0, 5, 5), Atb=torch.zeros(0, 5),
         u=torch.zeros(0, 5)),                                           # no blocks
])
def test_cuda_argument_checks(bad):
    args = _good()
    lu._check_cuda_args(**args)          # the well-formed call passes
    args.update(bad)
    with pytest.raises((ValueError, TypeError)):
        lu._check_cuda_args(**args)


def test_unsupported_device_raises():
    args = {k: v.to("meta") for k, v in _good().items()}
    with pytest.raises(ValueError):
        lu.fused_local_update(args["Finv"], args["Atb"], args["u"], args["z"], 1.0)
