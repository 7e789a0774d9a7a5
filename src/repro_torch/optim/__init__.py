"""Optimizers and the learning-rate schedule of the port."""
from repro_torch.optim.optimizers import (OptState, adafactor_init, adafactor_update,
                                          adamw_init, adamw_update, clip_by_global_norm,
                                          global_norm, make_optimizer)
from repro_torch.optim.schedule import warmup_cosine

__all__ = ["OptState", "adamw_init", "adamw_update", "adafactor_init",
           "adafactor_update", "clip_by_global_norm", "global_norm",
           "make_optimizer", "warmup_cosine"]
