"""Serving subsystem of the port: continuous-batching engine over the
dense slot cache, prefill through K3 and decode through K6."""
from repro_torch.serve.cache import (cache_bytes, mask_pad_rows, read_slot,
                                     slot_bytes, write_slot)
from repro_torch.serve.engine import (DecodeState, Prefix, Request,
                                      RequestOutput, ServeEngine)
from repro_torch.serve.sampling import SamplingParams, sample_tokens

__all__ = [
    "ServeEngine", "Request", "RequestOutput", "Prefix", "DecodeState",
    "SamplingParams", "sample_tokens", "write_slot", "mask_pad_rows",
    "read_slot", "cache_bytes", "slot_bytes",
]
