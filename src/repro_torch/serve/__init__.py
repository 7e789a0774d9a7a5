"""Serving subsystem of the port: continuous-batching engine over the
dense slot cache (decode through K6) or paged fp / int8 / int4 / svd
pools (decode through K7 / K8), prefill through K3; copy-on-write prefix
sharing and speculative verify on the paged layout."""
from repro_torch.serve.cache import (cache_bytes, mask_pad_rows, read_slot,
                                     slot_bytes, write_slot)
from repro_torch.serve.paging import PageAllocator, PoolSpec
from repro_torch.serve.engine import (DecodeState, Prefix, Request,
                                      RequestOutput, ServeEngine)
from repro_torch.serve.sampling import SamplingParams, sample_tokens

__all__ = [
    "ServeEngine", "Request", "RequestOutput", "Prefix", "DecodeState",
    "SamplingParams", "sample_tokens", "write_slot", "mask_pad_rows",
    "read_slot", "cache_bytes", "slot_bytes", "PageAllocator", "PoolSpec",
]
