"""Launch counts of the port's kernels and of their plain versions.

Each CUDA wrapper adds one under its own name right after its kernel
launched, and each plain version adds one under ``<name>_ref`` per call,
so a run can show which path its attention took. K3's two routes count
apart: ``flash_attention_fwd`` (bf16, tensor cores) and
``flash_attention_fwd_f32`` (f32, scalar). The counts are
process-wide: a caller that reads them zeroes them first with
:func:`reset`.
"""
from __future__ import annotations

import collections

LAUNCHES: collections.Counter = collections.Counter()


def reset() -> None:
    LAUNCHES.clear()


def counts() -> dict[str, int]:
    return dict(LAUNCHES)
