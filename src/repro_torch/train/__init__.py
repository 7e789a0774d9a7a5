"""Training of the port: the single-process (jit) executor."""
from repro_torch.train.train_step import (TrainState, finish_metrics, init_train_state,
                                          loss_and_grad, make_train_step)

__all__ = ["TrainState", "init_train_state", "loss_and_grad", "finish_metrics",
           "make_train_step"]
