"""Consensus ADMM over scenario blocks, on one device or across a
``torch.distributed`` process group.

Counterpart of ``epsilon_tpu/parallel/consensus.py``:

    minimize  sum_i f_i(x_i) + g(z)   s.t.  x_i = z  for all blocks i

- ``local_prox(v, data)``  computes argmin f_i(x) + rho/2 ||x - v||^2 for
  every block of the rank at once: ``v`` is (S_local, n).
- ``global_prox(v)``       computes argmin g(z) + (S*rho/2)||z - v||^2.

The x-update over blocks is embarrassingly parallel, so each rank of the
group keeps a contiguous S/world_size of the blocks; the reductions ADMM
needs (the consensus sum every iteration, the residual norms once per
epoch) are ``all_reduce(SUM)`` over the group.  ``z`` and ``rho`` are the
same on every rank, and every decision is taken from all-reduced values,
so all ranks run the same number of iterations.

The loop is eager PyTorch with one host read per epoch (the residuals and
the convergence flag).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

from .. import config
from ..ops import linop
from ..ops.kernels import local_update as lu

__all__ = ["ConsensusADMM", "ConsensusResult", "consensus_lasso_solver",
           "block_mesh"]


def block_mesh():
    """The process group over the block axis: the world group of an
    initialised ``torch.distributed`` (see :func:`initialize_distributed`)."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("block_mesh: torch.distributed is not initialised; "
                           "call epsilon_tpu_torch.parallel.initialize_distributed first")
    return dist.group.WORLD


def _local_blocks(S: int, group) -> slice:
    """This rank's contiguous share of the S blocks."""
    if group is None:
        return slice(0, S)
    world = dist.get_world_size(group)
    if S % world:
        raise ValueError(f"S={S} not divisible by group size {world}")
    per = S // world
    rank = dist.get_rank(group)
    return slice(rank * per, (rank + 1) * per)


@dataclasses.dataclass
class ConsensusResult:
    z: torch.Tensor
    iterations: int
    r_norm: float
    s_norm: float
    converged: bool
    # per-epoch (r_norm, s_norm) residual series
    series: Optional[np.ndarray] = None


class ConsensusADMM:
    """Scenario-sharded consensus ADMM.

    Args:
      local_prox: (v, data) -> x, the prox of every block at penalty rho,
        batched over the rank's blocks: ``v`` and the result are
        (S_local, n), ``data`` the rank's dict of tensors.  This is the one
        signature that differs from the JAX package, whose ``local_prox``
        takes one block and runs under ``vmap``.
      global_prox: (v,) -> z, prox of the global regularizer at S*rho; v (n,).
      data: dict of tensors with leading block axis S (each rank keeps its
        contiguous S/world_size blocks), or already the rank's S/world_size
        blocks.
      n: dimension of the consensus variable z.
      group: ``torch.distributed`` process group over the block axis
        (:func:`block_mesh`); None = one device (no collectives, same math).
      local_update: optional fused override (data, x, u, z[, rho]) ->
        (x, sum over the rank's blocks of x + u); the consensus lasso's
        explicit-inverse path passes the fused CUDA kernel.
      adaptive_rho: residual balancing (Boyd et al. sec. 3.4.1) once per
        epoch; rho is carried in the state and both proxes take it as a
        trailing argument.
    """

    def __init__(self, local_prox: Callable, global_prox: Callable,
                 data, S: int, n: int, rho: float = 1.0, group=None,
                 rel_tol: float = 1e-3, abs_tol: float = 1e-6,
                 max_iterations: int = 10000, epoch_iterations: int = 10,
                 local_update: Optional[Callable] = None,
                 adaptive_rho: bool = False, rho_mu: float = 10.0,
                 rho_tau: float = 2.0, over_relaxation: float = 1.0):
        self.local_update = local_update
        self.adaptive_rho = adaptive_rho
        self.rho_mu, self.rho_tau = rho_mu, rho_tau
        self.over_relaxation = over_relaxation
        self.local_prox = local_prox
        self.global_prox = global_prox
        self.S, self.n = S, n
        self.rho = rho
        self.group = group
        self.rel_tol, self.abs_tol = rel_tol, abs_tol
        self.max_iterations = max_iterations
        self.epoch_iterations = epoch_iterations
        self.n_collectives = 0   # collectives this solver has started
        blocks = _local_blocks(S, group)
        self.S_local = blocks.stop - blocks.start
        self.data = {k: v[blocks] if v.shape[0] == S else v for k, v in data.items()}
        for k, v in self.data.items():
            if v.shape[0] != self.S_local:
                raise ValueError(f"data[{k!r}] has {v.shape[0]} blocks; expected "
                                 f"{S} or this rank's {self.S_local}")

    def _all_reduce(self, t):
        if self.group is not None:
            self.n_collectives += 1
            dist.all_reduce(t, op=dist.ReduceOp.SUM, group=self.group)
        return t

    def _local_step(self, x, u, z, rho, residuals: bool):
        """One sweep over the rank's blocks.  With ``residuals``, also the
        all-reduced (||x - z||^2, ||x||^2, ||u||^2) of the sweep."""
        if self.local_update is not None:
            args = (self.data, x, u, z) + ((rho,) if self.adaptive_rho else ())
            x, xu_local = self.local_update(*args)
        else:
            v = z[None, :] - u
            x = (self.local_prox(v, self.data, rho) if self.adaptive_rho
                 else self.local_prox(v, self.data))
            xu_local = torch.sum(x + u, dim=0)
        alpha = self.over_relaxation
        if alpha != 1.0:
            x_hat = alpha * x + (1.0 - alpha) * z[None, :]
            xu_local = torch.sum(x_hat + u, dim=0)
        else:
            x_hat = x
        xu_sum = self._all_reduce(xu_local)
        if self.adaptive_rho:
            z_new = self.global_prox(xu_sum / self.S, rho)
        else:
            z_new = self.global_prox(xu_sum / self.S)
        u_new = u + x_hat - z_new[None, :]
        if not residuals:
            return x, u_new, z_new, None
        stats = torch.stack([torch.sum((x - z_new[None, :]) ** 2),
                             torch.sum(x * x), torch.sum(u_new * u_new)])
        return x, u_new, z_new, self._all_reduce(stats)

    def _epoch(self, state):
        """``epoch_iterations`` sweeps, then the residuals, read to the host
        once.  The dual residual uses the final sweep's ``z - z_prev`` and
        the rho the epoch ran with, as the JAX package does."""
        x, u, z, rho = state
        E = self.epoch_iterations
        for k in range(E):
            z_prev = z
            x, u, z, stats = self._local_step(x, u, z, rho, residuals=k == E - 1)
        dz = z - z_prev
        r_sq, x_sq, u_sq, dz_sq, z_sq = torch.cat(
            [stats, torch.stack([torch.sum(dz * dz), torch.sum(z * z)])]).tolist()
        sqrt_S = math.sqrt(self.S)
        r_norm = math.sqrt(r_sq)
        s_norm = rho * sqrt_S * math.sqrt(dz_sq)
        sqrt_n = math.sqrt(self.S * self.n)
        eps_p = self.abs_tol * sqrt_n + self.rel_tol * max(math.sqrt(x_sq),
                                                           sqrt_S * math.sqrt(z_sq))
        eps_d = self.abs_tol * sqrt_n + self.rel_tol * rho * math.sqrt(u_sq)
        conv = r_norm <= eps_p and s_norm <= eps_d

        if self.adaptive_rho:
            # residual balancing: keep ||r|| and ||s|| within a factor mu,
            # rescaling the scaled dual u when rho changes
            mu, tau = self.rho_mu, self.rho_tau
            factor = tau if r_norm > mu * s_norm else (
                1.0 / tau if s_norm > mu * r_norm else 1.0)
            if factor != 1.0:
                rho = rho * factor
                u = u / factor
        return (x, u, z, rho), (r_norm, s_norm), conv

    def init_state(self):
        dtype, dev = config.default_dtype(), config.device()
        x = torch.zeros((self.S_local, self.n), dtype=dtype, device=dev)
        u = torch.zeros((self.S_local, self.n), dtype=dtype, device=dev)
        z = torch.zeros(self.n, dtype=dtype, device=dev)
        return (x, u, z, float(self.rho))

    def solve(self, state=None) -> ConsensusResult:
        """Run epochs until converged or ``max_iterations`` (rounded down to
        whole epochs, at least one).  Starts from zeros when given no state;
        the final state is kept in ``_last_state``."""
        if state is None:
            state = self.init_state()
        max_epochs = max(1, self.max_iterations // self.epoch_iterations)
        series = []
        for _ in range(max_epochs):
            state, res, conv = self._epoch(state)
            series.append(res)
            if conv:
                break
        self._last_state = state
        return ConsensusResult(
            z=state[2], iterations=len(series) * self.epoch_iterations,
            r_norm=res[0], s_norm=res[1], converged=conv,
            series=np.asarray(series))


def consensus_lasso_solver(A_blocks, b_blocks, lam: float, rho: float = 1.0,
                           group=None, use_pallas="auto",
                           adaptive_rho: bool = False, **kwargs
                           ) -> ConsensusADMM:
    """Consensus lasso: minimize sum_i 1/2||A_i x - b_i||^2 + lam ||x||_1,
    blocks split over the group's ranks (BASELINE config[4]).

    ``A_blocks`` (S, m, n) and ``b_blocks`` (S, m) are host arrays; each rank
    uploads its own blocks, forms ``A_i'A_i`` and ``A_i'b_i`` on the device
    and keeps only the factors.  The local prox is a cached ridge solve in
    one of three modes: an eigendecomposition for adaptive rho, the
    explicit inverse (``config.use_explicit_inverse()``, the CUDA default)
    or triangular solves.  Global prox = soft threshold at lam/(S*rho).

    ``use_pallas`` keeps the JAX package's name and meaning ("auto" on the
    accelerator, True forced, False off): in explicit-inverse mode with
    n >= 128 the local update runs the fused hand-written CUDA kernel
    (:func:`~epsilon_tpu_torch.ops.kernels.local_update.fused_local_update`),
    whose plain PyTorch version runs on the CPU.
    """
    A_blocks = np.asarray(A_blocks)
    b_blocks = np.asarray(b_blocks)
    S, m, n = A_blocks.shape
    blocks = _local_blocks(S, group)
    A = linop.to_tensor(A_blocks[blocks])
    b = linop.to_tensor(b_blocks[blocks])
    AtA = torch.bmm(A.transpose(1, 2), A)
    Atb = torch.bmm(A.transpose(1, 2), b.unsqueeze(-1)).squeeze(-1)
    del A, b

    if adaptive_rho:
        # eigendecomposition-based factor cache: (A'A + rho I)^{-1} =
        # Q diag(1/(eig + rho)) Q^T, so rho changes are free
        eig, Q = torch.linalg.eigh(AtA)
        data = {"Q": Q, "eig": eig,
                "QtAtb": torch.einsum("sij,si->sj", Q, Atb)}

        def local_prox(v, d, rho_t):
            w = d["QtAtb"] + rho_t * torch.einsum("sij,si->sj", d["Q"], v)
            y = w / (d["eig"] + rho_t)
            return torch.einsum("sij,sj->si", d["Q"], y)

        thresh_scale = lam / S

        def global_prox(v, rho_t):
            t = thresh_scale / rho_t
            return torch.sign(v) * torch.clamp(torch.abs(v) - t, min=0.0)

        return ConsensusADMM(local_prox, global_prox, data, S, n, rho=rho,
                             group=group, adaptive_rho=True, **kwargs)
    if config.use_explicit_inverse():
        # factor once as explicit inverses, computed on the host in f64 as
        # the JAX package does, then cast and uploaded: the per-iteration
        # solve is one batched matvec
        AtA_h = AtA.cpu().to(torch.float64).numpy()
        Finv = linop.to_tensor(np.linalg.inv(AtA_h + rho * np.eye(n)))
        data = {"Finv": Finv, "Atb": Atb}

        def local_prox(v, d):
            return torch.bmm(d["Finv"], (d["Atb"] + rho * v).unsqueeze(-1)).squeeze(-1)
    else:
        L = torch.linalg.cholesky(
            AtA + rho * torch.eye(n, dtype=AtA.dtype, device=AtA.device))
        data = {"L": L, "Atb": Atb}

        def local_prox(v, d):
            rhs = d["Atb"] + rho * v
            return torch.cholesky_solve(rhs.unsqueeze(-1), d["L"]).squeeze(-1)

    thresh = lam / (S * rho)

    def global_prox(v):
        return torch.sign(v) * torch.clamp(torch.abs(v) - thresh, min=0.0)

    local_update = None
    if config.use_explicit_inverse() and (
            use_pallas is True or (use_pallas == "auto" and config.on_cuda())):
        if lu.local_update_supported(S, n):
            def local_update(d, x, u, z):
                return lu.fused_local_update(d["Finv"], d["Atb"], u, z, rho)

    return ConsensusADMM(local_prox, global_prox, data, S, n, rho=rho,
                         group=group, local_update=local_update, **kwargs)
