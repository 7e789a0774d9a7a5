"""Dense decoder of the port (serving subset)."""
from repro_torch.models.model import (Model, decode_step, init_caches,
                                      init_model, prefill, resolve_device)

__all__ = ["Model", "init_model", "init_caches", "prefill", "decode_step",
           "resolve_device"]
