from . import ops, ref  # noqa: F401
from .ops import rope  # noqa: F401
