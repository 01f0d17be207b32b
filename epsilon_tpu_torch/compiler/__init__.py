from . import affine, compiler, prox_rules, separate, text_format, validate  # noqa: F401
from .compiler import compile_problem  # noqa: F401
