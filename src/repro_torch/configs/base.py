"""Architecture + run configuration dataclasses and the config registry.

``ModelConfig`` is pure architecture (mesh/policy independent).
``RunConfig`` holds training-time choices: compression policy, dtypes,
remat, chunk sizes, optimizer.

A model is a sequence of *stages*; each stage is a repeated *unit* of block
kinds, e.g. recurrentgemma-9b = ``((("rec","rec","latt"), 12), (("rec","rec"), 1))``.
Stages with repeat > 1 keep their per-layer parameters stacked along a
leading axis; the PyTorch port runs them as a Python loop over that axis.

This is the port's own copy of ``repro.configs.base`` (the port imports
nothing of ``repro``); the registry data is identical.

Block kinds:
  attn   — self-attention (+ optional sliding window via cfg) + dense-FFN
  swa    — self-attention with cfg.sliding_window + dense-FFN
  moe    — self-attention + mixture-of-experts FFN
  latt   — local attention (cfg.local_window) + dense-FFN  (recurrentgemma)
  rec    — RG-LRU recurrent block + dense-FFN              (recurrentgemma)
  xattn  — cross-attention on image embeddings + dense-FFN (vision)
  ssm    — Mamba-2 SSD block (no separate FFN)
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

Stage = tuple[tuple[str, ...], int]

ATTN_KINDS = ("attn", "swa", "moe", "latt", "xattn")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | hybrid | vlm | audio | ssm
    d_model: int
    n_layers: int
    vocab_size: int
    stages: tuple[Stage, ...]
    # --- attention ---
    n_heads: int = 0
    n_kv_heads: int = 0
    head_dim: int = 0
    d_ff: int = 0
    qkv_bias: bool = False
    qk_norm: bool = False
    sliding_window: int = 0          # 0 = full attention (kind "swa" requires > 0)
    rope_theta: float = 10000.0
    # --- MoE ---
    n_experts: int = 0
    n_experts_per_tok: int = 0
    moe_d_ff: int = 0
    n_shared_experts: int = 0
    capacity_factor: float = 1.25
    # --- SSM (mamba2) ---
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_headdim: int = 64
    ssm_ngroups: int = 1
    conv_width: int = 4
    ssm_chunk: int = 128
    # --- RG-LRU (recurrentgemma) ---
    lru_width: int = 0
    local_window: int = 0
    # --- VLM ---
    vision_tokens: int = 0           # image embedding tokens per sample (stub frontend)
    # --- audio (musicgen) ---
    n_codebooks: int = 0
    embed_inputs: bool = False       # True => input is precomputed embeddings (B, L, d)
    # --- bookkeeping ---
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    source: str = ""                 # provenance tag from the assignment
    sub_quadratic: bool = False      # eligible for long_500k decode

    def __post_init__(self):
        n = sum(len(unit) * rep for unit, rep in self.stages)
        if n != self.n_layers:
            raise ValueError(f"{self.name}: stages cover {n} layers, expected {self.n_layers}")

    @property
    def d_head_total(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def ssm_d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_nheads(self) -> int:
        return self.ssm_d_inner // self.ssm_headdim

    def param_count(self) -> int:
        """Analytic parameter count (used for MODEL_FLOPS = 6*N*D in §Roofline)."""
        return _param_count(self)

    def active_param_count(self) -> int:
        """Params touched per token (MoE counts only routed-in experts)."""
        return _param_count(self, active_only=True)


def _ffn_params(d_model: int, d_ff: int) -> int:
    return 3 * d_model * d_ff  # SwiGLU: gate, up, down


def _attn_params(cfg: ModelConfig) -> int:
    qkv = cfg.d_model * (cfg.n_heads + 2 * cfg.n_kv_heads) * cfg.head_dim
    out = cfg.n_heads * cfg.head_dim * cfg.d_model
    bias = (cfg.n_heads + 2 * cfg.n_kv_heads) * cfg.head_dim if cfg.qkv_bias else 0
    qknorm = 2 * cfg.head_dim if cfg.qk_norm else 0
    return qkv + out + bias + qknorm + 2 * cfg.d_model  # + two RMSNorm scales


def _param_count(cfg: ModelConfig, active_only: bool = False) -> int:
    total = cfg.vocab_size * cfg.d_model  # embedding
    if cfg.n_codebooks:
        total = cfg.n_codebooks * cfg.vocab_size * cfg.d_model
    head = cfg.d_model * cfg.vocab_size * max(1, cfg.n_codebooks)
    total += head + cfg.d_model  # lm head + final norm
    for unit, rep in cfg.stages:
        for kind in unit:
            if kind in ("attn", "swa", "latt", "xattn"):
                blk = _attn_params(cfg) + _ffn_params(cfg.d_model, cfg.d_ff)
            elif kind == "moe":
                experts = cfg.n_experts_per_tok if active_only else cfg.n_experts
                moe = (experts + cfg.n_shared_experts) * _ffn_params(cfg.d_model, cfg.moe_d_ff)
                moe += cfg.d_model * cfg.n_experts  # router
                blk = _attn_params(cfg) + moe
            elif kind == "rec":
                w = cfg.lru_width
                rec = 2 * cfg.d_model * w + w * cfg.d_model  # in x2, out
                rec += 2 * w * w // max(1, w // w)           # gates (diag-block approx: dense)
                rec += cfg.conv_width * w + w                # conv + Lambda
                blk = rec + _ffn_params(cfg.d_model, cfg.d_ff) + 2 * cfg.d_model
            elif kind == "ssm":
                din, st, nh = cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_nheads
                inp = cfg.d_model * (2 * din + 2 * cfg.ssm_ngroups * st + nh)
                conv = cfg.conv_width * (din + 2 * cfg.ssm_ngroups * st)
                blk = inp + conv + 3 * nh + din + din * cfg.d_model + cfg.d_model
            else:
                raise ValueError(kind)
            total += blk * rep
    return total


@dataclasses.dataclass(frozen=True)
class RunConfig:
    """Training/serving-time knobs, orthogonal to the architecture."""

    # --- activation compression -------------------------------------------
    # ``compression`` is the canonical way to configure compression: a
    # CompressionPlan spec (core/plan.py, DESIGN.md §2), e.g.
    #   "attn.qkv=pamm(r=1/512,eps=inf);ffn.*=compact(r=1/4);ssm.in=none"
    # When empty, the DEPRECATED flat fields below are translated into an
    # equivalent spec (core.plan.plan_spec_from_legacy) — they resolve to
    # bit-identical per-site policies and remain supported for old configs.
    compression: str = ""
    policy_name: str = "pamm"        # DEPRECATED: pamm | uniform_crs | compact | none
    pamm_ratio: float = 1.0 / 512.0  # DEPRECATED: use r= in the plan spec
    pamm_eps: float = math.inf       # DEPRECATED: use eps= in the plan spec
    pamm_blocks: int = 1             # DEPRECATED: blocks= (auto = DP degree of mesh)
    pamm_k_max: Optional[int] = None # DEPRECATED: k_max=
    use_kernel: bool = False         # DEPRECATED: backend=pallas (auto on TPU)
    pamm_on_recurrent: bool = False  # DEPRECATED: rglru.in=pamm(...)
    pamm_on_ssm_inproj: bool = False # DEPRECATED: ssm.in=pamm(...)
    pamm_shard_local: bool = True    # DEPRECATED: blocks=auto derives from mesh
    compute_dtype: str = "bfloat16"
    param_dtype: str = "float32"
    remat: str = "none"              # none | full | pamm (save_only pamm_state + block outs)
    block_structure: str = "residual"  # residual | reversible: two-stream revnet
                                     # blocks whose backward reconstructs the
                                     # residual stream instead of saving it
                                     # (models/blocks.reversible_stage);
                                     # train-time only, excludes remat!=none.
    attn_chunk: int = 1024           # query-block size for chunked attention
    ring_block: int = 0              # bq=bk tile size for ring context-parallel
                                     # attention chunk pairs (0 = the flash
                                     # kernel default, 128); small shard
                                     # chunks clamp it internally, so this
                                     # only matters for tuning long shards
    loss_chunk: int = 1024           # sequence-block size for chunked cross-entropy
    lr: float = 3e-3
    pamm_lr_scale: float = 0.25      # paper App. D: PAMM-wrapped weights use alpha*lr
    weight_decay: float = 0.0
    warmup_frac: float = 0.1
    grad_clip: float = 1.0
    optimizer: str = "adamw"         # adamw | adafactor
    zero1: bool = True               # shard optimizer state over the data axis
    seq_shard: bool = False          # Megatron-style sequence parallelism between blocks
    moe_aux_coef: float = 0.01
    flash_sdp: bool = True           # FlashAttention memory semantics: recompute
                                     # scores/probs in backward (paper App. D.1
                                     # baseline trains with FlashAttention-2)
    attn_kernel: str = "auto"        # attention backend: auto | pallas | jnp.
                                     # auto = Pallas kernels on TPU, jnp
                                     # oracles elsewhere. Governs TRAINING and
                                     # prefill (kernels/flash_attention.py —
                                     # fwd+bwd custom_vjp, so jax.grad runs
                                     # Pallas both directions) and decode
                                     # (kernels/flash_decode.py). jnp training
                                     # = chunked sdpa with flash_sdp remat.
    grad_compress: str = "none"      # none | int8_ef (error-feedback int8 all-reduce)
    pad_vocab_multiple: int = 0      # pad embed/head vocab dim to a multiple
                                     # (0 = off). Odd vocabs (49155, 50280)
                                     # otherwise force a REPLICATED lm head —
                                     # the §Perf granite fix.
    cache_layout: str = "dense"      # serving decode-cache layout: dense
                                     # (slot-contiguous (B, max_len, ...)
                                     # slabs) | paged (global page pools +
                                     # per-slot block tables, serve/paging
                                     # — cache bytes track actual tokens)
    kv_page_size: int = 64           # tokens per KV page (paged layout);
                                     # also the paged decode kernel's kv
                                     # tile, so keep it >= the dtype's
                                     # sublane granule on real TPUs
    cache_compress: str = ""         # cache-side CompressionPlan spec for
                                     # the paged KV pools (core/plan.py):
                                     # "int8" | "int4(group=64)" |
                                     # "svd(r=1/4)" — or full rule form
                                     # "cache.kv=int8". Empty = fp pools.
    grad_accum: int = 1              # microbatch accumulation steps
    pad_experts_multiple: int = 0    # pad MoE expert axis (granite 40 -> 48)
    moe_gather_dispatch: bool = True # gather-based EP dispatch (vs value scatter)
    moe_token_blocks: int = 1        # per-data-shard MoE dispatch (set = DP degree)
    seed: int = 0


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------
_CONFIGS: dict[str, Callable[[], ModelConfig]] = {}


def register(name: str):
    def deco(fn: Callable[[], ModelConfig]):
        _CONFIGS[name] = fn
        return fn
    return deco


def get_config(name: str) -> ModelConfig:
    if name not in _CONFIGS:
        # import side-effect registration
        import repro_torch.configs  # noqa: F401
        if name not in _CONFIGS:
            raise ValueError(f"unknown arch {name!r}; have {sorted(_CONFIGS)}")
    return _CONFIGS[name]()


def list_configs() -> list[str]:
    import repro_torch.configs  # noqa: F401
    return sorted(_CONFIGS)
