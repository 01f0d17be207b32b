from .consensus import (ConsensusADMM, ConsensusResult, block_mesh,  # noqa: F401
                        consensus_lasso_solver)
from .distributed import choose_backend, initialize_distributed  # noqa: F401
from .dryrun import dryrun_multichip  # noqa: F401
