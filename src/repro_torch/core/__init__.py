"""PAMM core of the port: compression policies, compressed projection
sites, the CompressionPlan grammar and activation-memory accounting."""
from repro_torch.core.keys import Key, TorchSampler
from repro_torch.core.linear import STATS_LEN, CompressedSite
from repro_torch.core.pamm import (
    PammState,
    num_generators,
    pamm_apply,
    pamm_compress,
    pamm_reconstruct,
    stored_elements,
)
from repro_torch.core.plan import (
    CompressionPlan,
    ResolvedPlan,
    Site,
    SiteCtx,
    as_resolved,
    enumerate_sites,
    exact_ctx,
    make_run_plan,
    plan_spec_from_legacy,
    resolve_for_run,
)
from repro_torch.core.policies import (
    CompActPolicy,
    CompressionPolicy,
    ExactPolicy,
    PammPolicy,
    UniformCRSPolicy,
    make_policy,
)
from repro_torch.core.stats import (
    ActivationReport,
    plan_activation_report,
    qkv_activation_bytes,
    site_telemetry_metrics,
)

__all__ = [
    "Key", "TorchSampler", "STATS_LEN", "CompressedSite", "PammState",
    "num_generators", "pamm_apply", "pamm_compress", "pamm_reconstruct",
    "stored_elements", "CompressionPlan", "ResolvedPlan", "Site", "SiteCtx",
    "as_resolved", "enumerate_sites", "exact_ctx", "make_run_plan",
    "plan_spec_from_legacy", "resolve_for_run", "CompActPolicy",
    "CompressionPolicy", "ExactPolicy", "PammPolicy", "UniformCRSPolicy",
    "make_policy", "ActivationReport", "plan_activation_report",
    "qkv_activation_bytes", "site_telemetry_metrics",
]
