from .synthetic import (
    chunk_boundaries,
    classification_batch,
    coded_slot_batch,
    gc_chunked_batch,
    token_batch,
)

__all__ = [
    "chunk_boundaries",
    "classification_batch",
    "coded_slot_batch",
    "gc_chunked_batch",
    "token_batch",
]
