from . import ops, ref  # noqa: F401
from .ops import buffer_stats, window_stats  # noqa: F401
