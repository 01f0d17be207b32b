from . import elementwise  # noqa: F401
from .operator import ProxOperator, create_prox_operator  # noqa: F401
from .registry import KERNELS, get_kernel  # noqa: F401
