"""The 10 assigned architectures (exact numbers from the assignment brief)
plus the paper's own LLaMA sizes. Each registered name is selectable via
``--arch <id>`` in the launchers.

Every config also ships a ``<id>_smoke`` reduced sibling: same family and
block pattern, tiny widths — used by per-arch CPU smoke tests.
"""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig, register


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------
def _dense(name, L, d, h, kv, dff, vocab, **kw) -> ModelConfig:
    return ModelConfig(
        name=name, family="dense", d_model=d, n_layers=L, vocab_size=vocab,
        stages=((("attn",), L),), n_heads=h, n_kv_heads=kv, head_dim=d // h,
        d_ff=dff, **kw,
    )


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------
@register("granite-moe-3b-a800m")
def granite():
    # [hf:ibm-granite/granite-3.0-*-a*-base; hf] 32L d=1536 24H (GQA kv=8)
    # moe_d_ff=512, vocab=49155, 40 experts top-8
    return ModelConfig(
        name="granite-moe-3b-a800m", family="moe", d_model=1536, n_layers=32,
        vocab_size=49155, stages=((("moe",), 32),), n_heads=24, n_kv_heads=8,
        head_dim=64, d_ff=512, moe_d_ff=512, n_experts=40, n_experts_per_tok=8,
        source="hf:ibm-granite/granite-3.0-1b-a400m-base",
    )


@register("kimi-k2-1t-a32b")
def kimi():
    # [arXiv:2501.kimi2] 61L d=7168 64H (GQA kv=8) moe_d_ff=2048 vocab=163840
    # 384 routed experts top-8 + 1 shared; first layer dense (d_ff=18432).
    return ModelConfig(
        name="kimi-k2-1t-a32b", family="moe", d_model=7168, n_layers=61,
        vocab_size=163840, stages=((("attn",), 1), (("moe",), 60)),
        n_heads=64, n_kv_heads=8, head_dim=112, d_ff=18432, moe_d_ff=2048,
        n_experts=384, n_experts_per_tok=8, n_shared_experts=1,
        source="arXiv:2501.kimi2 (paper-table)",
    )


# ---------------------------------------------------------------------------
# dense
# ---------------------------------------------------------------------------
@register("internlm2-1.8b")
def internlm2():
    return _dense("internlm2-1.8b", 24, 2048, 16, 8, 8192, 92544,
                  source="arXiv:2403.17297")


@register("qwen2-72b")
def qwen2():
    return _dense("qwen2-72b", 80, 8192, 64, 8, 29568, 152064,
                  qkv_bias=True, rope_theta=1e6, source="arXiv:2407.10671")


@register("h2o-danube-3-4b")
def danube():
    # llama+mistral mix with sliding-window attention
    cfg = ModelConfig(
        name="h2o-danube-3-4b", family="dense", d_model=3840, n_layers=24,
        vocab_size=32000, stages=((("swa",), 24),), n_heads=32, n_kv_heads=8,
        head_dim=120, d_ff=10240, sliding_window=4096, sub_quadratic=True,
        source="arXiv:2401.16818",
    )
    return cfg


@register("qwen3-32b")
def qwen3():
    return ModelConfig(
        name="qwen3-32b", family="dense", d_model=5120, n_layers=64,
        vocab_size=151936, stages=((("attn",), 64),), n_heads=64, n_kv_heads=8,
        head_dim=80, d_ff=25600, qk_norm=True, rope_theta=1e6,
        source="hf:Qwen/Qwen3-8B family",
    )


# ---------------------------------------------------------------------------
# hybrid / ssm
# ---------------------------------------------------------------------------
@register("recurrentgemma-9b")
def recurrentgemma():
    # 38L, RG-LRU : local-attn at 2:1 -> unit (rec, rec, latt) x12 + (rec, rec)
    return ModelConfig(
        name="recurrentgemma-9b", family="hybrid", d_model=4096, n_layers=38,
        vocab_size=256000, stages=((("rec", "rec", "latt"), 12), (("rec", "rec"), 1)),
        n_heads=16, n_kv_heads=1, head_dim=256, d_ff=12288,
        lru_width=4096, local_window=2048, sub_quadratic=True,
        source="arXiv:2402.19427",
    )


@register("mamba2-370m")
def mamba2():
    return ModelConfig(
        name="mamba2-370m", family="ssm", d_model=1024, n_layers=48,
        vocab_size=50280, stages=((("ssm",), 48),), ssm_state=128,
        ssm_expand=2, ssm_headdim=64, ssm_ngroups=1, conv_width=4,
        sub_quadratic=True, source="arXiv:2405.21060",
    )


# ---------------------------------------------------------------------------
# multimodal
# ---------------------------------------------------------------------------
@register("llama-3.2-vision-11b")
def llama_vision():
    # 40L total: cross-attn every 5th layer -> unit (attn x4, xattn) x8.
    # Vision frontend is a stub: input_specs supplies precomputed patch
    # embeddings (B, vision_tokens, d).
    return ModelConfig(
        name="llama-3.2-vision-11b", family="vlm", d_model=4096, n_layers=40,
        vocab_size=128256, stages=((("attn", "attn", "attn", "attn", "xattn"), 8),),
        n_heads=32, n_kv_heads=8, head_dim=128, d_ff=14336, rope_theta=5e5,
        vision_tokens=1601, source="hf:meta-llama/Llama-3.2-11B-Vision",
    )


@register("musicgen-medium")
def musicgen():
    # decoder-only over EnCodec tokens, 4 codebooks; frame-embedding frontend
    # is a stub (embeds in, 4 x 2048 logit heads out). MHA (kv == heads).
    return ModelConfig(
        name="musicgen-medium", family="audio", d_model=1536, n_layers=48,
        vocab_size=2048, stages=((("attn",), 48),), n_heads=24, n_kv_heads=24,
        head_dim=64, d_ff=6144, n_codebooks=4, embed_inputs=True,
        source="arXiv:2306.05284",
    )


# ---------------------------------------------------------------------------
# the paper's own LLaMA family (Touvron 2023 sizing used by GaLore/CompAct)
# ---------------------------------------------------------------------------
@register("llama-60m")
def llama_60m():
    return _dense("llama-60m", 8, 512, 8, 8, 1376, 32000, source="paper §4.2")


@register("llama-tiny")
def llama_tiny():
    # CPU-scale stand-in for the paper's LLaMA family (benchmark harnesses)
    return _dense("llama-tiny", 4, 128, 4, 4, 344, 512, source="paper §4.2 scaled")


@register("llama-350m")
def llama_350m():
    return _dense("llama-350m", 24, 1024, 16, 16, 2736, 32000, source="paper §4.2")


@register("llama-1b")
def llama_1b():
    return _dense("llama-1b", 24, 2048, 32, 32, 5461, 32000, source="paper §4.2")


@register("llama-7b")
def llama_7b():
    return _dense("llama-7b", 32, 4096, 32, 32, 11008, 32000, source="paper App. E")


# ---------------------------------------------------------------------------
# reduced smoke siblings (same family/pattern, tiny widths)
# ---------------------------------------------------------------------------
@register("granite-moe-3b-a800m_smoke")
def granite_smoke():
    return ModelConfig(
        name="granite-moe-3b-a800m_smoke", family="moe", d_model=64, n_layers=2,
        vocab_size=256, stages=((("moe",), 2),), n_heads=4, n_kv_heads=2,
        head_dim=16, d_ff=64, moe_d_ff=64, n_experts=8, n_experts_per_tok=2,
    )


@register("kimi-k2-1t-a32b_smoke")
def kimi_smoke():
    return ModelConfig(
        name="kimi-k2-1t-a32b_smoke", family="moe", d_model=64, n_layers=3,
        vocab_size=256, stages=((("attn",), 1), (("moe",), 2)),
        n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128, moe_d_ff=32,
        n_experts=8, n_experts_per_tok=2, n_shared_experts=1,
    )


@register("internlm2-1.8b_smoke")
def internlm2_smoke():
    return _dense("internlm2-1.8b_smoke", 2, 64, 4, 2, 128, 256)


@register("qwen2-72b_smoke")
def qwen2_smoke():
    return _dense("qwen2-72b_smoke", 2, 64, 4, 2, 128, 256, qkv_bias=True)


@register("h2o-danube-3-4b_smoke")
def danube_smoke():
    return ModelConfig(
        name="h2o-danube-3-4b_smoke", family="dense", d_model=64, n_layers=2,
        vocab_size=256, stages=((("swa",), 2),), n_heads=4, n_kv_heads=2,
        head_dim=16, d_ff=128, sliding_window=8, sub_quadratic=True,
    )


@register("qwen3-32b_smoke")
def qwen3_smoke():
    return _dense("qwen3-32b_smoke", 2, 64, 4, 2, 128, 256, qk_norm=True)


@register("recurrentgemma-9b_smoke")
def recurrentgemma_smoke():
    return ModelConfig(
        name="recurrentgemma-9b_smoke", family="hybrid", d_model=64, n_layers=5,
        vocab_size=256, stages=((("rec", "rec", "latt"), 1), (("rec", "rec"), 1)),
        n_heads=4, n_kv_heads=1, head_dim=16, d_ff=128, lru_width=64,
        local_window=8, sub_quadratic=True,
    )


@register("mamba2-370m_smoke")
def mamba2_smoke():
    return ModelConfig(
        name="mamba2-370m_smoke", family="ssm", d_model=64, n_layers=2,
        vocab_size=256, stages=((("ssm",), 2),), ssm_state=16, ssm_expand=2,
        ssm_headdim=16, ssm_ngroups=1, conv_width=4, ssm_chunk=8,
        sub_quadratic=True,
    )


@register("llama-3.2-vision-11b_smoke")
def llama_vision_smoke():
    return ModelConfig(
        name="llama-3.2-vision-11b_smoke", family="vlm", d_model=64, n_layers=5,
        vocab_size=256, stages=((("attn", "attn", "attn", "attn", "xattn"), 1),),
        n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128, vision_tokens=16,
    )


@register("musicgen-medium_smoke")
def musicgen_smoke():
    return ModelConfig(
        name="musicgen-medium_smoke", family="audio", d_model=64, n_layers=2,
        vocab_size=64, stages=((("attn",), 2),), n_heads=4, n_kv_heads=4,
        head_dim=16, d_ff=128, n_codebooks=4, embed_inputs=True,
    )
