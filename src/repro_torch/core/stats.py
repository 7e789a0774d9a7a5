"""Activation-memory accounting and telemetry (``repro/core/stats.py``).

The paper reports "peak attention memory" = bytes of all saved Q/K/V
projection input activations. Here that is the byte size of the
compressed sites' saved states across all attention layers, computed
analytically from the policy and shapes (:func:`qkv_activation_bytes`,
:func:`plan_activation_report`); the per-site runtime telemetry
(:func:`site_telemetry_metrics`) reports what was actually stored.
"""
from __future__ import annotations

import dataclasses

import torch

__all__ = [
    "ActivationReport",
    "qkv_activation_bytes",
    "site_telemetry_metrics",
    "serving_cache_metrics",
    "plan_activation_report",
]


def _itemsize(dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


@dataclasses.dataclass(frozen=True)
class ActivationReport:
    policy: str
    layers: int
    tokens_per_batch: int
    hidden: int
    baseline_bytes: int
    compressed_bytes: int

    @property
    def saving(self) -> float:
        return 1.0 - self.compressed_bytes / max(1, self.baseline_bytes)

    def __str__(self) -> str:
        mb = 1024 * 1024
        return (
            f"[{self.policy}] QKV activations over {self.layers} layers: "
            f"{self.compressed_bytes / mb:.2f} MB vs {self.baseline_bytes / mb:.2f} MB "
            f"baseline ({100 * self.saving:.2f}% saved)"
        )


def qkv_activation_bytes(policy, *, n_layers: int, batch: int, seq: int,
                         hidden: int, dtype=torch.bfloat16) -> ActivationReport:
    """Bytes stored for the QKV projections' inputs across the whole model:
    one state per attention layer, shared by Q, K and V."""
    b = batch * seq
    itemsize = _itemsize(dtype)
    return ActivationReport(
        policy=policy.name,
        layers=n_layers,
        tokens_per_batch=b,
        hidden=hidden,
        baseline_bytes=n_layers * b * hidden * itemsize,
        compressed_bytes=n_layers * policy.stored_elements(b, hidden) * itemsize,
    )


def site_telemetry_metrics(tele: dict) -> dict:
    """Flatten a telemetry accumulator (site path -> STATS_LEN vector, see
    core/linear.py) into scalar metrics (0-d tensors):

      site/<path>/stored_mb   bytes actually saved-for-backward at the site
      site/<path>/kept_frac   fraction of token rows contributing to the
                              estimate (all-zero padding rows never do)
      site/<path>/beta        mean de-bias factor
    """
    out = {}
    for path, v in tele.items():
        out[f"site/{path}/stored_mb"] = v[0] / (1024.0 * 1024.0)
        out[f"site/{path}/kept_frac"] = v[1] / v[2].clamp_min(1.0)
        out[f"site/{path}/beta"] = v[3] / v[4].clamp_min(1.0)
    return out


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


def plan_activation_report(resolved, *, batch: int, seq: int,
                           dtype=torch.bfloat16) -> list[ActivationReport]:
    """Analytic stored-bytes report for every compressed site of a resolved
    plan. Sites backed by a sibling's shared state (``shared_with``) are
    skipped so the one state is not counted twice."""
    itemsize = _itemsize(dtype)
    reports = []
    for s in resolved.sites:
        if s.is_exact or s.shared_with is not None:
            continue
        reports.append(ActivationReport(
            policy=f"{s.path}:{s.policy.name}",
            layers=s.multiplicity,
            tokens_per_batch=batch * seq,
            hidden=s.n_in,
            baseline_bytes=s.multiplicity * batch * seq * s.n_in * itemsize,
            compressed_bytes=s.multiplicity
            * s.policy.stored_elements(batch * seq, s.n_in) * itemsize,
        ))
    return reports
