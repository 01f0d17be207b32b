from .consensus import (ConsensusADMM, ConsensusResult, block_mesh,  # noqa: F401
                        consensus_lasso_solver)
from .distributed import initialize_distributed  # noqa: F401
