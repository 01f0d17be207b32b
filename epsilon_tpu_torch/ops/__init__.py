from . import linop  # noqa: F401
from .block import BlockMatrix, BlockVector  # noqa: F401
from .cholesky import BlockCholesky  # noqa: F401
