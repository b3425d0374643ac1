"""Checkpoints of the port: trees and blobs in the JAX package's npz format."""

from .io import (
    load_blob,
    load_pytree,
    restore_train_state,
    save_blob,
    save_pytree,
    save_train_state,
)

__all__ = [
    "save_pytree",
    "load_pytree",
    "save_train_state",
    "restore_train_state",
    "save_blob",
    "load_blob",
]
