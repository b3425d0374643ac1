from . import ops, ref  # noqa: F401
from .ops import rmsnorm  # noqa: F401
