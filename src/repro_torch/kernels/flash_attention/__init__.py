from . import ops, ref  # noqa: F401
from .flash_attention import flash_attention  # noqa: F401
from .ops import attention  # noqa: F401
