"""Training of the port: the single-process (jit) executor; and the serving
entry points outside the engine loop (greedy decoding)."""
from repro_torch.train.serve_step import (greedy_decode, greedy_decode_per_token,
                                          make_decode_step, make_prefill)
from repro_torch.train.train_step import (TrainState, finish_metrics, init_train_state,
                                          loss_and_grad, make_train_step)

__all__ = ["TrainState", "init_train_state", "loss_and_grad", "finish_metrics",
           "make_train_step", "make_prefill", "make_decode_step", "greedy_decode",
           "greedy_decode_per_token"]
