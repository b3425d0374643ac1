from .coded import (
    chunk_loss_sum,
    gc_round_weights,
    init_train_state,
    make_coded_train_step,
    make_serve_step,
    make_train_step,
)
from .driver import CodedTrainingDriver, MLPModel, VectorizedCodedTrainer, run_adaptive

__all__ = [
    "CodedTrainingDriver",
    "MLPModel",
    "VectorizedCodedTrainer",
    "chunk_loss_sum",
    "gc_round_weights",
    "init_train_state",
    "make_coded_train_step",
    "make_serve_step",
    "make_train_step",
    "run_adaptive",
]
