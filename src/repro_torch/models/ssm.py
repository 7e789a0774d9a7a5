"""Mamba-2 (SSD, state-space duality, arXiv:2405.21060) block
(``repro/models/ssm.py``).

Training and prefill run the chunked SSD algorithm. Where the JAX package
scans the chunks with ``lax.scan``, the port computes every chunk's
intra-chunk terms (the decay-masked ``C·Bᵀ`` contraction) and its state
contribution in batched products over all chunks at once, and keeps only
the state recurrence ``S_{c+1} = S_c · exp(cum_last_c) + contrib_c``
sequential: a few small ops per chunk. ``C·Bᵀ`` is computed once per
group and broadcast over the group's heads, never repeated per head.
Decode is the O(1)-per-token recurrence h <- h·exp(dt·A) + dt·B⊗x,
written into the slot cache in place.

The intra-chunk decay ``exp(cum_q - cum_s)`` is masked to -inf above the
diagonal *before* the exp (JAX takes the exp of every pair and zeroes
the upper triangle after): the kept values are the same, and the upper
triangle contributes exact zeros to the backward instead of ``0 · exp``,
which can be ``0 · inf``.

The in-projection is the ``ssm.in`` compression site (``ctx.apply``: K1
and K2 under a PAMM rule, exact by default); decode uses a plain product.

Under tensor parallelism (``runtime.sharding.model_group`` with ``ssm``)
a model rank runs its nh/tp heads. The block's input enters whole
(``tp_enter``); ``ssm.in`` is a column-parallel site: K1 compresses the
whole rows, the same state on every rank, and K2 takes the rank's
``in_proj`` columns -- its heads' z, x and dt and the group's B and C,
whole on every rank (``runtime/sharding.py``'s head-aligned cut), so
their gradient, and that of ``conv_w``'s B / C columns and of the whole
``a_log`` / ``d_skip`` / ``dt_bias`` a rank reads its heads of, is
summed over the model group. The conv and the chunked SSD run on the
rank's heads. ``out_norm`` normalises over the whole inner width: the
f32 sum of squares is summed over the group (forward and backward) and
divided by din. ``out_proj`` is row-parallel (``tp_exit``).
"""
from __future__ import annotations

import dataclasses
from typing import ClassVar

import torch
import torch.nn.functional as F

from repro_torch.models.attention import _CacheNode
from repro_torch.models.layers import causal_depthwise_conv, dense_init, rms_norm
from repro_torch.runtime.collectives import (copy_cols_to_model, copy_to_model, model_sum,
                                              tp_enter, tp_exit)
from repro_torch.runtime.sharding import model_group


@dataclasses.dataclass
class SSMCache(_CacheNode):
    """A slot's recurrent state. Per layer: state (B, H, P, N) f32, the
    SSM state; conv_state (B, W-1, conv_dim) in the compute dtype, the
    last W-1 conv inputs. Both hold the batch slot at axis 1 when stacked
    over the layers, like a dense KV node."""

    LEAVES: ClassVar[tuple[str, ...]] = ("state", "conv_state")
    state: torch.Tensor
    conv_state: torch.Tensor


def _dims(cfg):
    din = cfg.ssm_d_inner
    nh = cfg.ssm_nheads
    ng, st = cfg.ssm_ngroups, cfg.ssm_state
    conv_dim = din + 2 * ng * st
    d_in_proj = 2 * din + 2 * ng * st + nh
    return din, nh, ng, st, conv_dim, d_in_proj


def init_ssm(gen: torch.Generator, cfg, dtype) -> dict:
    """One layer's parameters: the projections and conv in ``dtype``;
    ``a_log``, ``d_skip`` and ``dt_bias`` in f32 and deterministic, as in
    the JAX package."""
    din, nh, ng, st, conv_dim, d_in_proj = _dims(cfg)
    dev = gen.device
    f32 = dict(dtype=torch.float32, device=dev)
    return {
        "in_proj": dense_init(gen, cfg.d_model, d_in_proj, dtype),
        "conv_w": (torch.randn((cfg.conv_width, conv_dim), generator=gen, device=dev)
                   * 0.2).to(dtype),
        "a_log": torch.log(torch.linspace(1.0, 16.0, nh, **f32)),
        "d_skip": torch.ones((nh,), **f32),
        "dt_bias": torch.log(torch.expm1(torch.full((nh,), 0.01, **f32))),
        "out_norm": torch.zeros((din,), dtype=dtype, device=dev),
        "out_proj": dense_init(gen, din, cfg.d_model, dtype),
    }


def _split_in_proj(cfg, zxbcdt):
    din, nh, _, _, conv_dim, _ = _dims(cfg)
    return torch.split(zxbcdt, [din, conv_dim, nh], dim=-1)


def _tp_ssm(params, cfg, mg):
    """This rank's ssm parameters under tensor parallelism and its (din,
    nh, ng): ``in_proj`` / ``conv_w`` / ``out_norm`` / ``out_proj`` hold
    its slices already; one group's B / C columns, whole on every rank,
    and the rank's heads of ``a_log`` / ``d_skip`` / ``dt_bias`` pass
    through the mappings that sum their gradient over the model group."""
    din, nh, ng, st, _, _ = _dims(cfg)
    dl, hl = din // mg.tp, nh // mg.tp
    gl = ng if ng == 1 else ng // mg.tp
    out = dict(params)
    if ng == 1:
        out["in_proj"] = copy_cols_to_model(params["in_proj"], mg, 2 * dl, 2 * dl + 2 * st)
        out["conv_w"] = copy_cols_to_model(params["conv_w"], mg, dl, dl + 2 * st)
    h0 = mg.index * hl
    for name in ("a_log", "d_skip", "dt_bias"):
        out[name] = copy_to_model(params[name], mg)[h0:h0 + hl]
    return out, (dl, hl, gl)


def _out_norm(y, scale, cfg, mg):
    """``rms_norm`` over the whole inner width din: under tensor
    parallelism (``mg``) ``y`` holds this rank's din/tp columns, and the
    f32 sum of squares is summed over the model group."""
    if mg is None:
        return rms_norm(y, scale, cfg.norm_eps)
    y32 = y.float()
    var = model_sum(torch.sum(y32 * y32, dim=-1, keepdim=True), mg) / cfg.ssm_d_inner
    return ((y32 * torch.rsqrt(var + cfg.norm_eps)) * (1.0 + scale.float())).to(y.dtype)


def _ssd_chunked(x, dt, a, b, c, d_skip, chunk: int, init_state=None):
    """Chunked SSD scan.

    x: (B, L, H, P); dt: (B, L, H) (post-softplus); a: (H,) negative;
    b, c: (B, L, G, N). Returns (y (B, L, H, P) in x's dtype, final_state
    (B, H, P, N) f32). Head h reads group h // (H / G). The sequence is
    padded to whole chunks with dt = 0, which leaves the state unchanged.
    """
    B, L, H, Pd = x.shape
    G, N = b.shape[2], b.shape[3]
    rep = H // G
    nc = -(-L // chunk)
    pad = nc * chunk - L
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        b = F.pad(b, (0, 0, 0, 0, 0, pad))
        c = F.pad(c, (0, 0, 0, 0, 0, pad))
    Q = chunk
    # chunk-major, heads before the sequence: (B, nc, G, rep, Q, ...)
    xs = x.float().reshape(B, nc, Q, G, rep, Pd).permute(0, 1, 3, 4, 2, 5)
    dts = dt.float().reshape(B, nc, Q, G, rep).permute(0, 1, 3, 4, 2)
    bs = b.float().reshape(B, nc, Q, G, N).transpose(2, 3)          # (B, nc, G, Q, N)
    cs = c.float().reshape(B, nc, Q, G, N).transpose(2, 3)
    cum = torch.cumsum(dts * a.float().reshape(G, rep, 1), dim=-1)   # (B, nc, G, rep, Q)

    # intra-chunk: weight of x_s on y_q is (C_q·B_s) exp(cum_q - cum_s) dt_s, s <= q
    causal = torch.ones((Q, Q), dtype=torch.bool, device=x.device).tril()
    diff = (cum[..., :, None] - cum[..., None, :]).masked_fill(~causal, float("-inf"))
    cb = cs @ bs.transpose(-1, -2)                                    # (B, nc, G, Q, S)
    w = cb[:, :, :, None] * torch.exp(diff) * dts[..., None, :]       # (B, nc, G, rep, Q, S)
    y = w @ xs

    # each chunk's own contribution to the state it hands on
    seg = torch.exp(cum[..., -1:] - cum) * dts                         # (B, nc, G, rep, Q)
    contrib = (xs * seg[..., None]).transpose(-1, -2) @ bs[:, :, :, None]   # (.., P, N)
    # the recurrence over chunks: the state entering each chunk
    state = (torch.zeros((B, G, rep, Pd, N), dtype=torch.float32, device=x.device)
             if init_state is None else init_state.float().reshape(B, G, rep, Pd, N))
    chunk_decay = torch.exp(cum[..., -1])                              # (B, nc, G, rep)
    entering = []
    for ci in range(nc):
        entering.append(state)
        state = state * chunk_decay[:, ci, :, :, None, None] + contrib[:, ci]
    prev = torch.stack(entering, dim=1)                                # (B, nc, G, rep, P, N)
    y = y + (cs[:, :, :, None] @ prev.transpose(-1, -2)) * torch.exp(cum)[..., None]
    y = y + d_skip.float().reshape(G, rep, 1, 1) * xs
    y = y.permute(0, 1, 4, 2, 3, 5).reshape(B, nc * Q, H, Pd)[:, :L]
    return y.to(x.dtype), state.reshape(B, H, Pd, N)


def ssm_train(params, x, cfg, ctx, key, *, return_cache: bool = False):
    """x: (B, L, d_model) -> (B, L, d_model): full-sequence training or
    prefill. ``return_cache``: also return the :class:`SSMCache` the
    sequence leaves (its final SSM state and last W-1 conv inputs)."""
    din, nh, ng, st, _, _ = _dims(cfg)
    mg = model_group()
    split = mg is not None and mg.ssm
    x = tp_enter(x, mg, split)
    if split:
        params, (din, nh, ng) = _tp_ssm(params, cfg, mg)
    B, L, _ = x.shape
    zxbcdt = ctx.apply("ssm.in", x, params["in_proj"], None, key)
    z, xbc, dt = torch.split(zxbcdt, [din, din + 2 * ng * st, nh], dim=-1)
    xbc, conv_state = causal_depthwise_conv(xbc, params["conv_w"])
    xbc = F.silu(xbc)
    xin, bmat, cmat = torch.split(xbc, [din, ng * st, ng * st], dim=-1)
    xh = xin.reshape(B, L, nh, cfg.ssm_headdim)
    bmat = bmat.reshape(B, L, ng, st)
    cmat = cmat.reshape(B, L, ng, st)
    a = -torch.exp(params["a_log"].float())
    dt_full = F.softplus(dt.float() + params["dt_bias"].float())
    y, state = _ssd_chunked(xh, dt_full, a, bmat, cmat, params["d_skip"], cfg.ssm_chunk)
    y = _out_norm(y.reshape(B, L, din) * F.silu(z), params["out_norm"], cfg,
                  mg if split else None)
    out = tp_exit(y @ params["out_proj"].to(y.dtype), mg, split)
    if return_cache:
        return out, SSMCache(state=state, conv_state=conv_state)
    return out


def init_ssm_cache(cfg, B: int, dtype, device, layers: int | None = None) -> SSMCache:
    """Zero state (optionally stacked over ``layers``)."""
    _, nh, _, st, conv_dim, _ = _dims(cfg)
    lead = () if layers is None else (layers,)
    return SSMCache(
        state=torch.zeros(lead + (B, nh, cfg.ssm_headdim, st), dtype=torch.float32,
                          device=device),
        conv_state=torch.zeros(lead + (B, cfg.conv_width - 1, conv_dim), dtype=dtype,
                               device=device),
    )


def ssm_decode(params, x, cache: SSMCache, cfg):
    """One token for every slot: x (B, 1, d_model). The slots' rows are
    independent; every slot's state advances (a parked one too: the next
    admission overwrites it). Updates ``cache`` in place; returns (out,
    cache)."""
    din, nh, ng, st, _, _ = _dims(cfg)
    B = x.shape[0]
    rep, P = nh // ng, cfg.ssm_headdim
    zxbcdt = x @ params["in_proj"].to(x.dtype)
    z, xbc, dt = _split_in_proj(cfg, zxbcdt)
    xbc, conv_state = causal_depthwise_conv(xbc, params["conv_w"], cache.conv_state)
    xbc = F.silu(xbc)
    xin, bmat, cmat = torch.split(xbc, [din, ng * st, ng * st], dim=-1)
    xh = xin.reshape(B, ng, rep, P).float()
    bmat = bmat.reshape(B, ng, 1, 1, st).float()
    cmat = cmat.reshape(B, ng, 1, st, 1).float()
    a = -torch.exp(params["a_log"].float())
    dt1 = F.softplus(dt.reshape(B, nh).float() + params["dt_bias"].float())
    decay = torch.exp(dt1 * a).reshape(B, ng, rep, 1, 1)
    state = cache.state.reshape(B, ng, rep, P, st)
    state = state * decay + (dt1.reshape(B, ng, rep, 1) * xh)[..., None] * bmat
    y = (state @ cmat)[..., 0] + params["d_skip"].float().reshape(ng, rep, 1) * xh
    y = y.reshape(B, 1, din).to(x.dtype)
    y = rms_norm(y * F.silu(z), params["out_norm"], cfg.norm_eps)
    out = y @ params["out_proj"].to(y.dtype)
    cache.state.copy_(state.reshape(B, nh, P, st))
    cache.conv_state.copy_(conv_state)
    return out, cache
