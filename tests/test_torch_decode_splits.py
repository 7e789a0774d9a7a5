"""The split-over-keys arithmetic of the K6 and K8 kernels, on the CPU.

The CUDA kernels (``csrc/flash_decode_split.cuh``) run only on the card.
What they compute is pinned here by a torch emulation of the same steps:
each split walks its key range in tiles, keeps an online softmax (m, l)
and an unnormalised accumulator in f32 (m starts at -inf; a masked key
scores the finite NEG_INF, a tile slot with no key -inf; a tile without
a key is skipped), and a merge combines the splits in split order with
w_s = exp(m_s - max_s m_s) (every weight 0 where no split holds a key)
and the 1e-30 denominator floor. The emulation is held against the JAX
Pallas kernels in interpret mode and against the port's plain versions:

* K6 over K6's split rule (:func:`_dense_splits`: 256 slots a split, a
  function of S alone), with a split that holds no live key, a parked row
  (the mean of V over the slab), a ring window and S not a multiple of
  256;
* K8 over K7's page-aligned split ranges, int8 and int4 pages, a hole, a
  parked row and a row whose table maps no page (o = 0).

Tolerance: f32 atol 1e-5 (the same f32 math summed in another order).
"""
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_decode import flash_decode_kernel
from repro.kernels.flash_decode import flash_decode_ref as jax_decode_ref
from repro.kernels.flash_decode import flash_paged_decode_quant_kernel
from repro_torch.kernels import flash_decode
from repro_torch.kernels.flash_decode import (NEG_INF, dequantize_kv, flash_decode_ref,
                                              flash_paged_decode_quant_ref)

TOL = 1e-5
TILE = 64   # the kernels' tile at these widths (rows of at most 256 bytes)


def split_merge(q, k, v, q_pos, pos, present, ranges, *, bk=TILE, causal=True, window=0):
    """The kernels' split-and-merge, in torch f32.

    q (B, Lq, H, dh); k, v (B, N, KV, dh) in logical key order; q_pos (B,
    Lq); pos (B, N) key positions; present (B, N) False where a slot holds
    no key (an unmapped page); ranges: each split's [begin, end)."""
    q, k, v = q.float(), k.float(), v.float()
    B, Lq, H, dh = q.shape
    KV = k.shape[2]
    G = H // KV
    scale = dh ** -0.5
    o = torch.empty(B, Lq, H, dh)
    for b in range(B):
        qb = q[b].reshape(Lq, KV, G, dh).permute(1, 0, 2, 3).reshape(KV, Lq * G, dh)
        qp = q_pos[b].repeat_interleave(G)[None, :, None]          # (1, R, 1)
        parts = []
        for begin, end in ranges:
            m = torch.full((KV, Lq * G, 1), -torch.inf)
            l = torch.zeros(KV, Lq * G, 1)
            acc = torch.zeros(KV, Lq * G, dh)
            for t0 in range(begin, end, bk):
                t1 = min(t0 + bk, end)
                has = present[b, t0:t1]
                if not bool(has.any()):
                    continue                                        # skipped tile
                kt = k[b, t0:t1].permute(1, 0, 2)                   # (KV, n, dh)
                vt = v[b, t0:t1].permute(1, 0, 2)
                sp = pos[b, t0:t1][None, None, :]
                live = sp >= 0
                if causal:
                    live = live & (sp <= qp)
                if window > 0:
                    live = live & (qp - sp < window)
                s = torch.einsum("krd,knd->krn", qb, kt) * scale
                s = torch.where(live, s, NEG_INF)
                s = torch.where(has[None, None, :], s, -torch.inf)
                m_new = torch.maximum(m, s.amax(-1, keepdim=True))
                p = torch.exp(s - m_new)
                corr = torch.exp(m - m_new)
                l = corr * l + p.sum(-1, keepdim=True)
                acc = corr * acc + torch.einsum("krn,knd->krd", p, vt)
                m = m_new
            parts.append((m, l, acc))
        M = torch.stack([m for m, _, _ in parts]).amax(0)
        num = torch.zeros(KV, Lq * G, dh)
        den = torch.zeros(KV, Lq * G, 1)
        for m, l, acc in parts:                                     # split order
            w = torch.where(M == -torch.inf, 0.0, torch.exp(m - M))
            num = num + w * acc
            den = den + w * l
        ob = num / den.clamp_min(1e-30)
        o[b] = ob.reshape(KV, Lq, G, dh).permute(1, 0, 2, 3).reshape(Lq, H, dh)
    return o


# ---------------------------------------------------------------------------
# K6: the split rule and the dense split-and-merge
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("S", [1, 16, 255, 256, 257, 600, 1089, 4096, 4097])
def test_k6_split_rule_covers_every_slot_once_whatever_the_batch(S):
    """K6's split count depends on S alone (the rule takes no batch, card
    or data), so batched decode sums each row as a batch of 1 would; the
    splits tile [0, S) with each slot in exactly one, none empty."""
    assert list(inspect.signature(flash_decode._dense_splits).parameters) == ["S"]
    nsplit, per = flash_decode._dense_splits(S)
    assert per == flash_decode.DENSE_SPLIT_KEYS == 256
    ranges = [(s * per, min(S, (s + 1) * per)) for s in range(nsplit)]
    covered = np.zeros(S, int)
    for begin, end in ranges:
        assert begin < end                                          # every split holds a slot
        covered[begin:end] += 1
    assert (covered == 1).all()
    if S == 1089:
        assert nsplit == 5                                          # the serving shape: 320 blocks


def _dense_ranges(S):
    nsplit, per = flash_decode._dense_splits(S)
    return [(s * per, min(S, (s + 1) * per)) for s in range(nsplit)]


K6_CASES = [
    # B, S, H, KV, dh, n_valid, ring (tokens written into a ring of S), window
    (3, 600, 4, 2, 32, 590, 0, 0),      # S not a multiple of 256: splits of 256, 256, 88
    (2, 700, 4, 1, 16, 300, 0, 0),      # split 2 ([512, 700)) holds no live key
    (2, 600, 4, 2, 32, 0, 1500, 256),   # a ring of 600, window 256: split 2 sees nothing
    (1, 64, 8, 2, 80, 50, 0, 0),        # one split, head dim 80
]


@pytest.mark.parametrize("B,S,H,KV,dh,n_valid,ring,window", K6_CASES)
def test_k6_split_merge_matches_jax_kernel_and_plain(B, S, H, KV, dh, n_valid, ring, window):
    rng = np.random.default_rng(S + dh + ring)
    q = rng.standard_normal((B, 1, H, dh), dtype=np.float32)
    k = rng.standard_normal((B, S, KV, dh), dtype=np.float32)
    v = rng.standard_normal((B, S, KV, dh), dtype=np.float32)
    j = np.arange(S)
    if ring:
        last = ring - 1 - ((ring - 1 - j) % S)
        spos = np.broadcast_to(last, (B, S)).astype(np.int32)
        qpos = np.full((B,), ring - 1, np.int32)
    else:
        spos = np.broadcast_to(np.where(j < n_valid, j, -1), (B, S)).astype(np.int32)
        qpos = np.full((B,), n_valid - 1, np.int32)
    qpos[-1] = -1 if B > 1 else qpos[-1]                            # a parked row
    qt, kt, vt, qpt, spt = (torch.from_numpy(np.ascontiguousarray(a))
                            for a in (q, k, v, qpos, spos))
    o = split_merge(qt, kt, vt, qpt[:, None], spt, torch.ones(B, S, dtype=torch.bool),
                    _dense_ranges(S), window=window)
    assert torch.isfinite(o).all()
    o_plain = flash_decode_ref(qt, kt, vt, qpt, spt, causal=True, window=window)
    torch.testing.assert_close(o, o_plain, atol=TOL, rtol=0)       # parked row: mean over S
    jargs = [jnp.asarray(a) for a in (q, k, v, qpos, spos)]
    o_jref = np.asarray(jax_decode_ref(*jargs, causal=True, window=window))
    np.testing.assert_allclose(o.numpy(), o_jref, atol=TOL)
    # the Pallas kernel pads S to its tile (16 here) with empty slots,
    # which a parked row averages too: only rows that see a key compare
    o_kern = np.asarray(flash_decode_kernel(*jargs, causal=True, window=window, bk=16,
                                            interpret=True))
    live = qpos >= 0
    np.testing.assert_allclose(o.numpy()[live], o_kern[live], atol=TOL)
    if ring or n_valid < S // 2:
        # the dead split is real: its keys are masked for every live row
        begin, end = _dense_ranges(S)[-1]
        seen = (spos[0, begin:end] >= 0) & (spos[0, begin:end] <= qpos[0])
        if window:
            seen &= qpos[0] - spos[0, begin:end] < window
        assert not seen.any()


# ---------------------------------------------------------------------------
# K8: K7's page-aligned splits over int8 / int4 pages
# ---------------------------------------------------------------------------
K8_CASES = [
    # B, nb, ps, H, KV, dh, Lq, bits, ngr, nsplit
    (3, 6, 16, 4, 2, 32, 1, 8, 1, 3),    # int8, 3 splits of 2 pages (tiles straddle pages)
    (3, 6, 16, 4, 2, 32, 2, 4, 2, 6),    # int4, grouped scales, a page a split, Lq 2
    (3, 5, 16, 8, 2, 64, 1, 4, 1, 1),    # int4, one split
    (3, 7, 16, 4, 1, 32, 1, 8, 4, 2),    # MQA, 4 groups of 8, splits of 4 and 3 pages
]


@pytest.mark.parametrize("B,nb,ps,H,KV,dh,Lq,bits,ngr,nsplit", K8_CASES)
def test_k8_split_merge_matches_jax_kernel(B, nb, ps, H, KV, dh, Lq, bits, ngr, nsplit):
    """Row 0 has a hole (an unmapped page), row 1 is parked (the mean of V
    over its mapped pages), row 2's table maps no page (o = 0)."""
    rng = np.random.default_rng(nb * ps + dh + bits + nsplit)
    S = nb * ps
    n_pages = B * nb + 2
    w = dh if bits == 8 else dh // 2
    kp, vp = (rng.integers(-127 if bits == 8 else -128, 128, size=(n_pages, ps, KV, w))
              .astype(np.int8) for _ in range(2))
    ks, vs = ((rng.random((n_pages, ps, KV, ngr)) * 0.05 + 0.01).astype(np.float32)
              for _ in range(2))
    bt = rng.permutation(n_pages)[:B * nb].reshape(B, nb).astype(np.int32)
    fill = np.array([S - 5, S - 20, S - 9])[:B]
    slots = np.arange(S).reshape(nb, ps)
    ppos = rng.integers(0, S, size=(n_pages, ps)).astype(np.int32)
    for b in range(B):
        ppos[bt[b]] = np.where(slots < fill[b], slots, -1)
    bt[0, 1] = -1                                                   # a hole
    bt[2] = -1                                                      # no page at all
    q = rng.standard_normal((B, Lq, H, dh)).astype(np.float32)
    qpos = (fill[:, None] - Lq + np.arange(Lq)[None]).astype(np.int32)
    qpos[1] = -1                                                    # a parked row
    per = -(-nb // nsplit)
    ranges = [(e * ps, min(nb, e + per) * ps) for e in range(0, nb, per)]
    assert len(ranges) == -(-nb // per)

    targs = [torch.from_numpy(a) for a in (q, kp, vp, ks, vs, qpos, bt, ppos)]
    kd = dequantize_kv(targs[1], targs[3], dh)                      # (n_pages, ps, KV, dh) f32
    vd = dequantize_kv(targs[2], targs[4], dh)
    btc = targs[6].clamp_min(0).long()
    present = (targs[6] >= 0)[:, :, None].expand(B, nb, ps).reshape(B, S)
    o = split_merge(targs[0], kd[btc].reshape(B, S, KV, dh), vd[btc].reshape(B, S, KV, dh),
                    targs[5], targs[7][btc].reshape(B, S), present, ranges)
    assert torch.isfinite(o).all()
    assert not o[2].any()                                           # no mapped page: o = 0
    o_kern = np.asarray(flash_paged_decode_quant_kernel(
        jnp.asarray(q), *(jnp.asarray(a) for a in (kp, vp, ks, vs, qpos, bt, ppos)),
        causal=True, window=0, interpret=True), np.float32)
    np.testing.assert_allclose(o.numpy(), o_kern, atol=TOL)       # every row, parked included
    o_plain = flash_paged_decode_quant_ref(*targs)
    np.testing.assert_allclose(o.numpy()[0], o_plain.numpy()[0], atol=TOL)
