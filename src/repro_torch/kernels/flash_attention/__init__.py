from . import ops, ref  # noqa: F401
from .flash_attention import flash_attention, flash_attention_bwd  # noqa: F401
from .ops import attention  # noqa: F401
