from . import ops, ref  # noqa: F401
from .ops import ssd_intra_chunk  # noqa: F401
