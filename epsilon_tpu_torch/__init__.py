"""epsilon_tpu_torch: the PyTorch/CUDA port of epsilon_tpu.

Same modeling surface as ``epsilon_tpu``: a DCP frontend compiles a convex
problem into prox-affine form ``minimize sum_i f_i(H_i(x)) s.t.
sum_i A_i x_i = b``, and ADMM (two-block or N-block) solves it with PyTorch tensors on
one device, CUDA by default (``config.set_device`` selects another)::

    import epsilon_tpu_torch as ep
    x = ep.Variable(n)
    prob = ep.Problem(ep.Minimize(ep.sum_squares(A @ x - b) + ep.norm1(x)))
    prob.solve()

The JAX package ``epsilon_tpu`` is the reference this port is tested
against; nothing here imports JAX.
"""

__version__ = "0.1.0"

from . import config  # noqa: F401
from .frontend import *  # noqa: F401,F403
from .frontend import api, eval_prox, solve  # noqa: F401
from .frontend.api import Parameter, _wrap, scalar_constant  # noqa: F401
from .frontend.functions import (hinge_loss, infinite_push, logistic_loss,  # noqa: F401
                                 multiclass_hinge_loss, one_hot, poisson_loss,
                                 quantile_loss, softmax_loss)
from .ir import ProxKind  # noqa: F401
from .solvers import SolverKind, SolverParams, SolverStatus  # noqa: F401
