"""Site context, exact path only (``repro/core/plan.py:SiteCtx``,
``exact_ctx``).

Serving runs every projection exactly, which is what ``SiteCtx`` does in
the JAX package when no resolved plan is given. Plan-spec parsing and
PAMM-compressed sites belong to the training slice; asking for them here
raises.
"""
from __future__ import annotations

from repro_torch.core.linear import _exact_linear

TRAINING_SLICE = ("compression plans (PAMM / CompAct sites) arrive with the "
                  "port's training slice")


class SiteCtx:
    """Runtime handle given to a block: applies each projection role
    exactly. ``resolved`` must be None in this slice."""

    __slots__ = ("resolved", "stage", "kind", "tele")

    def __init__(self, resolved, stage: int, kind: str, tele: dict | None):
        if resolved is not None:
            raise NotImplementedError(TRAINING_SLICE)
        self.resolved = resolved
        self.stage = stage
        self.kind = kind
        self.tele = tele

    def apply(self, role: str, x, w, bias, key=None):
        lead = x.shape[:-1]
        return _exact_linear(x.reshape(-1, w.shape[0]), w, bias).reshape(
            *lead, w.shape[1])

    def apply_shared(self, role: str, x, ws, biases, key=None):
        lead = x.shape[:-1]
        x2d = x.reshape(-1, ws[0].shape[0])
        return [_exact_linear(x2d, w, b).reshape(*lead, w.shape[1])
                for w, b in zip(ws, biases)]


def exact_ctx() -> SiteCtx:
    """A context that applies every projection exactly (decode/prefill)."""
    return SiteCtx(None, -1, "head", None)
