"""Projection sites of the port. This slice carries only the exact path
(serving); PAMM compression sites arrive with the training slice."""
from repro_torch.core.plan import SiteCtx, exact_ctx

__all__ = ["SiteCtx", "exact_ctx"]
