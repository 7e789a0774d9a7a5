"""The port's CompressionPlan (``repro_torch/core/plan.py``) against the
JAX package's: the cases of ``tests/test_plan.py`` run on both grammars
and must give the same rules, the same sites with the same ids, the same
policies and the same sharing; plus the port's own rules (``backend=``
accepted with one meaning, ``blocks=auto`` = 1 without a mesh). Exact
comparisons: resolution is pure bookkeeping.
"""
import dataclasses
import math
import warnings

import pytest

from repro.configs import RunConfig as JaxRunConfig
from repro.configs import get_config as jax_get_config
from repro.core import plan as jplan
from repro.core.stats import plan_activation_report as jax_report
from repro_torch.configs import RunConfig, get_config
from repro_torch.core import plan as tplan
from repro_torch.core.policies import CompActPolicy, ExactPolicy, PammPolicy
from repro_torch.core.stats import plan_activation_report, qkv_activation_bytes

SPECS = [
    "",
    "attn.qkv=pamm(r=1/512,eps=inf,blocks=4,k_max=32)",
    "ffn.*=exact; ssm.in=crs(r=1/8); lm_head=compact(r=1/4)",
    "*=compact(r=1/4);attn.qkv=pamm(r=1/8);stage0.attn.attn.qkv=none",
    "stage0.attn.attn.qkv=none;attn.qkv=pamm(r=1/8)",
    "attn.*=pamm(r=1/8)",
    "attn/*=compact(r=1/4)",
    "ffn.*=compact(r=1/4)",
    "ffn.gate=compact(r=1/4);ffn.up=compact(r=1/8)",
    "attn.qkv=pamm(r=1/8,backend=jnp,blocks=1);ffn.*=compact(r=1/4);ssm.in=none;"
    "lm_head=pamm(r=1/8,backend=jnp)",
    "rglru.in=pamm(r=1/4,eps=0.5);cache.kv=int8;swa/cache.kv=int4(group=32)",
    "cache.kv=svd(r=1/4);attn.qkv=pamm(ratio=1/4,k_max=none)",
]
ARCHS = ["internlm2-1.8b_smoke", "recurrentgemma-9b_smoke", "mamba2-370m_smoke",
         "llama-3.2-vision-11b_smoke", "h2o-danube-3-4b_smoke", "granite-moe-3b-a800m_smoke"]


def _policy_fields(p) -> dict:
    d = dataclasses.asdict(p)
    d.pop("use_kernel", None)          # the JAX policy's backend switch
    return d


def _resolve_both(spec, arch):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        j = jplan.CompressionPlan.parse(spec).resolve(jax_get_config(arch))
        t = tplan.CompressionPlan.parse(spec).resolve(get_config(arch))
    return j, t


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("spec", SPECS)
def test_resolution_matches_jax(spec, arch):
    jp, tp = jplan.CompressionPlan.parse(spec), tplan.CompressionPlan.parse(spec)
    assert [dataclasses.astuple(r) for r in jp.rules] == \
        [dataclasses.astuple(r) for r in tp.rules]
    j, t = _resolve_both(spec, arch)
    assert [(s.path, s.site_id, s.n_in, s.multiplicity, s.shared_with, s.policy.name)
            for s in j.sites] == \
        [(s.path, s.site_id, s.n_in, s.multiplicity, s.shared_with, s.policy.name)
         for s in t.sites]
    for sj, st in zip(j.sites, t.sites):
        assert _policy_fields(sj.policy) == _policy_fields(st.policy)
    assert [(c.path, str(c.fmt)) for c in j.cache_sites] == \
        [(c.path, str(c.fmt)) for c in t.cache_sites]
    assert sorted(j.zero_telemetry()) == sorted(t.zero_telemetry())
    assert [(r.policy, r.baseline_bytes, r.compressed_bytes)
            for r in jax_report(j, batch=2, seq=32)] == \
        [(r.policy, r.baseline_bytes, r.compressed_bytes)
         for r in plan_activation_report(t, batch=2, seq=32)]


@pytest.mark.parametrize("text,match", [
    ("attn.qkv=svd(r=1/2)", "unknown policy"),
    ("attn.qkv=compact(eps=1.0)", "does not accept arg"),
    ("attn.qkv", "pattern=policy"),
    ("=pamm", "empty site pattern"),
    ("attn.qkv=pamm(backend=triton)", "backend must be"),
])
def test_parse_errors_match_jax(text, match):
    for mod in (jplan, tplan):
        with pytest.raises(ValueError, match=match):
            mod.CompressionPlan.parse(text).resolve(get_config("internlm2-1.8b_smoke"))


def test_typo_warns_and_cross_arch_rule_is_silent():
    cfg = get_config("mamba2-370m_smoke")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        r = tplan.CompressionPlan.parse("attn.qkv=pamm(r=1/8)").resolve(cfg)
    assert r.compressed_sites == ()
    with pytest.warns(UserWarning, match="matches no site"):
        tplan.CompressionPlan.parse("atn.qkv=pamm(r=1/8)").resolve(cfg)


@pytest.mark.parametrize("flags", [{}, {"pamm_on_recurrent": True},
                                   {"policy_name": "compact"}, {"policy_name": "none"},
                                   {"pamm_k_max": 8, "pamm_blocks": 2}])
def test_legacy_flags_and_run_plan_match_jax(flags):
    jr, tr = JaxRunConfig(pamm_ratio=1 / 8, **flags), RunConfig(pamm_ratio=1 / 8, **flags)
    assert jplan.plan_spec_from_legacy(jr) == tplan.plan_spec_from_legacy(tr)
    arch = "recurrentgemma-9b_smoke"
    j = jplan.resolve_for_run(jax_get_config(arch), jr)
    t = tplan.resolve_for_run(get_config(arch), tr)
    assert [(s.path, _policy_fields(s.policy)) for s in j.sites] == \
        [(s.path, _policy_fields(s.policy)) for s in t.sites]
    pol = PammPolicy(ratio=1 / 8)
    res = tplan.as_resolved(pol, get_config(arch), tr)
    rec = res.site(0, "rec", "rglru.in").policy
    assert rec is pol if flags.get("pamm_on_recurrent") else isinstance(rec, ExactPolicy)
    assert isinstance(res.site(0, "rec", "ffn.gate").policy, ExactPolicy)


def test_port_backend_blocks_and_mesh_rules():
    """backend= is accepted with one meaning (kernel on CUDA, plain on the
    CPU), blocks=auto is 1 without a mesh (its mesh degree:
    tests/test_torch_distributed.py), and an explicit blocks= count is
    kept."""
    cfg = get_config("internlm2-1.8b_smoke")
    pols = {b: tplan.CompressionPlan.parse(f"attn.qkv=pamm(backend={b},blocks=auto)")
            .resolve(cfg).site(0, "attn", "attn.qkv").policy
            for b in ("auto", "jnp", "pallas")}
    assert len(set(pols.values())) == 1 and pols["auto"].n_blocks == 1
    assert tplan.CompressionPlan.parse("attn.qkv=pamm(blocks=2)").resolve(cfg) \
        .site(0, "attn", "attn.qkv").policy.n_blocks == 2
    r = tplan.CompressionPlan.parse("*=compact(r=1/4);attn.qkv=pamm(r=1/8)").resolve(cfg)
    assert isinstance(r.site(0, "attn", "ffn.gate").policy, CompActPolicy)
    assert r.site(0, "attn", "ffn.up").shared_with == "stage0.attn.ffn.gate"
    assert r.head_site().path == "lm_head"
    assert tplan.cache_plan_from_spec("int8").rules[0].pattern == "cache.kv"
    rep = qkv_activation_bytes(PammPolicy(), n_layers=24, batch=4, seq=2048, hidden=2048)
    assert rep.baseline_bytes == 24 * 8192 * 2048 * 2
    assert rep.compressed_bytes == 24 * (16 * 2048 + 2 * 8192) * 2
    assert math.isclose(rep.saving, 1 - rep.compressed_bytes / rep.baseline_bytes)
