from . import ops, ref  # noqa: F401
from .ops import coded_combine, coded_combine_tree  # noqa: F401
