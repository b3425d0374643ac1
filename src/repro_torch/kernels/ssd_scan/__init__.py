from . import ops, ref  # noqa: F401
from .ops import ssd_chunk_scan, ssd_intra_chunk  # noqa: F401
