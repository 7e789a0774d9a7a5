"""Serving cache telemetry (``repro/core/stats.py:serving_cache_metrics``)."""
from __future__ import annotations


def serving_cache_metrics(*, reserved_bytes: int, used_bytes: int,
                          capacity_bytes: int, pages_total: int = 0,
                          pages_free: int = 0,
                          compression_x: float = 1.0) -> dict:
    """Reserved-vs-used KV-cache telemetry: ``reserved`` is what admission
    has committed (dense: whole slabs of every occupied slot), ``used`` is
    tokens actually written, ``capacity`` is the allocated backing store."""
    mb = 1024.0 * 1024.0
    return {
        "cache/kv_capacity_mb": capacity_bytes / mb,
        "cache/kv_reserved_mb": reserved_bytes / mb,
        "cache/kv_used_mb": used_bytes / mb,
        "cache/kv_utilization": used_bytes / max(1, reserved_bytes),
        "cache/kv_pages_total": float(pages_total),
        "cache/kv_pages_free": float(pages_free),
        "cache/kv_compression_x": float(compression_x),
    }
