"""Dense decoder of the port: training (forward, loss_fn) and serving
(prefill, decode_step)."""
from repro_torch.models.model import (Model, decode_step, forward, init_caches,
                                      init_model, loss_fn, prefill, resolve_device)

__all__ = ["Model", "init_model", "forward", "loss_fn", "init_caches", "prefill",
           "decode_step", "resolve_device"]
