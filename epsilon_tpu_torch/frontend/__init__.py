from . import api, dcp, expression  # noqa: F401
from .api import *  # noqa: F401,F403
from .solve import eval_prox, solve  # noqa: F401
