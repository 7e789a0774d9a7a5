"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Every test here needs an NVIDIA GPU and skips without one; the
module imports no JAX, so it runs where only torch is installed:

  PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py -q

Tolerances: K3/K6/K7/K8 f32 atol 2e-5 on o (the same f32 math summed in another
order); bf16 atol 5e-2 on o (both round o to bf16); lse atol 1e-3.
K1: |cs| and norms to 1e-5 relative (f32 dots of up to a few thousand
terms in another order); idx equal wherever the plain top-2 |csim| margin
exceeds 1e-4. K1's split route: pass A to 1e-5 of its buffer's scale and
bitwise across launches, pass B to 1e-6 relative of its plain version on
the same buffer (the same f32 operations), and the two halves' route to
K1 on the whole rows as K1 is held. K2: 1e-5 of the output's scale (f32 sums in another order)
and bitwise equal across two launches. The batched K1 / K2 (the MoE
site's experts in one launch) are held the same way, and each expert's
output bitwise to a 2-D launch on that expert's inputs. K4/K5: f32 1e-4 and bf16 2e-2 of
each gradient's largest magnitude (f32 sums over up to L terms in another
order; bf16 rounds the outputs, and the tensor-core route rounds P and dS
to bf16 before their products), and every row of dh to its own norm
(floored at 1e-2 of the largest row, for rows near 0 by cancellation):
f32 1e-3, bf16 1e-2 (a bf16 rounding flip moves a row by at most 2^-7 of
its norm; a row that loses one 64-key tile of its i live keys moves by the
order of sqrt(64 / i) of it, which the largest-magnitude bound lets pass
for late rows); the bf16 route gives the same bits on a second launch. K7/K8 are compared on the rows that see at least one key;
a fully masked (parked) row must only be finite (the kernels average V
over the mapped pages, the plain versions over every gathered page), and
K6, K7 and K8, split over the keys, must give the same bits on a second
launch; K6's rows alone equal the same rows in a batch of 8, bit for bit. The
bf16 K3 and K7 are also held per row: f32 1e-5, bf16 1e-2 (K3 rounds P to
bf16 before P V). K3 with offsets is compared on the rows that see a key;
a row that sees none must have lse <= NEG_INF / 2 and a finite o.
"""
import pytest
import torch

from repro_torch.kernels import flash_decode, launches, ops, pamm_apply
from repro_torch.kernels.flash_attention import (NEG_INF, _iota_mask,
                                                 flash_attention_bwd_cuda,
                                                 flash_attention_bwd_ref,
                                                 flash_attention_fwd_cuda,
                                                 flash_attention_fwd_ref)
from repro_torch.kernels.flash_decode import (flash_decode_cuda, flash_decode_ref,
                                              flash_paged_decode_cuda,
                                              flash_paged_decode_quant_cuda,
                                              flash_paged_decode_quant_ref,
                                              flash_paged_decode_ref)
from repro_torch.kernels.pamm_apply import (segment_matmul_batched_cuda,
                                            segment_matmul_batched_ref, segment_matmul_cuda,
                                            segment_matmul_ref)
from repro_torch.kernels.pamm_compress import (csim_argmax_batched_cuda,
                                               csim_argmax_batched_ref, csim_argmax_cuda,
                                               csim_argmax_ref)

TOL = {"float32": 2e-5, "bfloat16": 5e-2}
K3_CASES = [
    # B, L, H, KV, dh, causal, window
    (1, 40, 4, 2, 16, True, 0),
    (2, 33, 4, 1, 80, True, 0),
    (1, 70, 4, 2, 128, True, 16),
    (1, 130, 2, 1, 16, True, 24),
    (1, 24, 2, 2, 16, False, 0),
    (1, 200, 4, 1, 112, True, 0),     # kimi's head dim
    (1, 150, 16, 1, 256, True, 64),   # recurrentgemma's head dim, MQA
    (1, 1000, 16, 2, 120, True, 0),   # danube's head dim, G 8, L not a multiple of 64
    (2, 257, 8, 8, 64, True, 100),    # MHA, dh 64, a window
    (1, 333, 16, 8, 32, False, 0),    # non-causal past five tiles
    (2, 1030, 16, 8, 128, True, 256), # internlm2's heads, a ring window of 256
    (1, 1030, 24, 8, 64, True, 0),    # granite's heads: G 3 at dh 64
    (2, 1030, 24, 24, 64, True, 0),   # musicgen's heads: MHA (G 1) at dh 64, L past 1024
]
K6_CASES = [
    # B, S, H, KV, dh, window, n_valid
    (2, 64, 4, 2, 64, 0, 64),
    (1, 96, 4, 1, 32, 0, 50),
    (2, 37, 8, 2, 80, 0, 37),
    (1, 16, 2, 2, 128, 8, 16),
    (3, 300, 16, 1, 256, 0, 260),     # G = 16 rows of dh 256
    (2, 129, 8, 8, 112, 0, 100),      # MHA, S past two tiles
    (8, 1089, 24, 8, 64, 0, 1000),    # granite's serving shape: G 3 at dh 64
    (8, 1089, 24, 24, 64, 0, 1032),   # musicgen's decode shape: MHA (G 1) at dh 64
]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _row_err(a, ref):
    """Largest |a_row - ref_row| / (|ref_row| + 1e-2 max |ref_row|)."""
    a, ref = a.float(), ref.float()
    den = ref.norm(dim=-1)
    return float(((a - ref).norm(dim=-1) / (den + 1e-2 * den.max()).clamp_min(1e-30)).max())


def _randn(shape, gen, dtype):
    return torch.randn(shape, generator=gen, device=gen.device).to(getattr(torch, dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,L,H,KV,dh,causal,window", K3_CASES)
def test_k3_cuda_matches_plain(cuda_device, B, L, H, KV, dh, causal, window, dtype):
    g = torch.Generator(device=cuda_device).manual_seed(L + dh)
    q, k, v = (_randn(s, g, dtype) for s in ((B, L, H, dh), (B, L, KV, dh), (B, L, KV, dh)))
    launches.reset()
    o, lse = flash_attention_fwd_cuda(q, k, v, causal=causal, window=window)
    route = "flash_attention_fwd" if dtype == "bfloat16" else "flash_attention_fwd_f32"
    assert launches.counts() == {route: 1}
    o_r, lse_r = flash_attention_fwd_ref(q, k, v, causal=causal, window=window)
    assert o.dtype == q.dtype and lse.dtype == torch.float32
    torch.testing.assert_close(o.float(), o_r.float(), atol=TOL[dtype], rtol=0)
    torch.testing.assert_close(lse, lse_r, atol=1e-3, rtol=0)
    # every row to its own norm (bf16: P is rounded to bf16 before P V)
    assert _row_err(o, o_r) <= (1e-5 if dtype == "float32" else 1e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("dh", [64, 120])
def test_k3_unaligned_rows_take_elementwise_loads(cuda_device, dh):
    """Tensors whose rows are not 16-byte aligned (a one-element offset
    into their storage) go through the tensor-core route's element-wise
    loads instead of cp.async, with the same result."""
    g = torch.Generator(device=cuda_device).manual_seed(dh)
    views = []
    for shape in ((1, 130, 4, dh), (1, 130, 2, dh), (1, 130, 2, dh)):
        n = torch.Size(shape).numel()
        views.append(_randn((n + 1,), g, "bfloat16")[1:].view(shape))
    q, k, v = views
    assert q.data_ptr() % 16 != 0
    o, lse = flash_attention_fwd_cuda(q, k, v, causal=True, window=40)
    o_r, lse_r = flash_attention_fwd_ref(q, k, v, causal=True, window=40)
    torch.testing.assert_close(o.float(), o_r.float(), atol=TOL["bfloat16"], rtol=0)
    torch.testing.assert_close(lse, lse_r, atol=1e-3, rtol=0)
    assert _row_err(o, o_r) <= 1e-2


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,H,KV,dh,window,n_valid", K6_CASES)
def test_k6_cuda_matches_plain(cuda_device, B, S, H, KV, dh, window, n_valid, dtype):
    g = torch.Generator(device=cuda_device).manual_seed(S + dh)
    q = _randn((B, 1, H, dh), g, dtype)
    k, v = _randn((B, S, KV, dh), g, dtype), _randn((B, S, KV, dh), g, dtype)
    j = torch.arange(S, device=cuda_device, dtype=torch.int32)
    spos = torch.where(j < n_valid, j, -1).expand(B, S).contiguous()
    qpos = torch.full((B,), n_valid - 1, dtype=torch.int32, device=cuda_device)
    qpos[0] = -1                                    # a parked row
    o = flash_decode_cuda(q, k, v, qpos, spos, causal=True, window=window)
    o_r = flash_decode_ref(q, k, v, qpos, spos, causal=True, window=window)
    assert torch.isfinite(o).all()
    torch.testing.assert_close(o.float(), o_r.float(), atol=TOL[dtype], rtol=0)


K6_SPLIT_CASES = [
    # B, S, H, KV, dh, window, n_valid, ring: S past several 256-slot splits
    (2, 1100, 16, 8, 128, 0, 1000, 0),    # five splits, the last of 76 slots
    (3, 900, 8, 2, 80, 0, 400, 0),        # splits 2 and 3 hold no live key
    (2, 600, 16, 8, 128, 256, 0, 1500),   # a ring of 600, window 256: split 2 sees nothing
    (1, 513, 16, 1, 256, 0, 513, 0),      # G = 16 rows of dh 256 (32-slot tiles), a 1-slot split
    (2, 777, 4, 2, 120, 0, 700, 0),       # head dim 120
]


def _k6_inputs(B, S, H, KV, dh, window, n_valid, ring, dtype, dev, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    q = _randn((B, 1, H, dh), g, dtype)
    k, v = _randn((B, S, KV, dh), g, dtype), _randn((B, S, KV, dh), g, dtype)
    j = torch.arange(S, device=dev)
    if ring:
        spos = (ring - 1 - ((ring - 1 - j) % S)).to(torch.int32).expand(B, S).contiguous()
        qpos = torch.full((B,), ring - 1, dtype=torch.int32, device=dev)
    else:
        spos = torch.where(j < n_valid, j, -1).to(torch.int32).expand(B, S).contiguous()
        qpos = torch.full((B,), n_valid - 1, dtype=torch.int32, device=dev)
    return q, k, v, qpos, spos


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,H,KV,dh,window,n_valid,ring", K6_SPLIT_CASES)
def test_k6_splits_match_plain_and_repeat_bitwise(cuda_device, B, S, H, KV, dh, window,
                                                  n_valid, ring, dtype):
    """K6 split over the slots (256 a split): S past several splits,
    splits whose keys are all masked for every live row, a parked row
    (the mean of V over the slab, as the plain version), a ring window;
    two launches give the same bits."""
    q, k, v, qpos, spos = _k6_inputs(B, S, H, KV, dh, window, n_valid, ring, dtype,
                                     cuda_device, S + dh + ring)
    if B > 1:
        qpos[-1] = -1                                     # a parked row
    launches.reset()
    o = flash_decode_cuda(q, k, v, qpos, spos, causal=True, window=window)
    again = flash_decode_cuda(q, k, v, qpos, spos, causal=True, window=window)
    assert launches.counts() == {"flash_decode": 2}       # split + merge count once
    o_r = flash_decode_ref(q, k, v, qpos, spos, causal=True, window=window)
    assert torch.equal(o, again)                          # no atomics, a fixed merge order
    assert torch.isfinite(o).all()
    torch.testing.assert_close(o.float(), o_r.float(), atol=TOL[dtype], rtol=0)
    assert _row_err(o, o_r) <= (1e-5 if dtype == "float32" else 1e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k6_batch_of_one_rows_bitwise_equal_batched(cuda_device, dtype):
    """The split count is a function of S alone, so each row of a batch
    of 8 is the same bits as that row decoded alone (the continuous-
    batching invariant)."""
    B, S, H, KV, dh = 8, 1089, 16, 8, 128
    q, k, v, qpos, spos = _k6_inputs(B, S, H, KV, dh, 0, S, 0, dtype, cuda_device, 11)
    fill = torch.tensor([S - 97 * b for b in range(B)], device=cuda_device)
    spos = torch.where(spos < fill[:, None], spos, -1).to(torch.int32)
    qpos = (fill - 1).to(torch.int32)
    qpos[3] = -1                                          # a parked row
    o = flash_decode_cuda(q, k, v, qpos, spos, causal=True)
    for b in range(B):
        one = flash_decode_cuda(q[b:b + 1], k[b:b + 1], v[b:b + 1], qpos[b:b + 1],
                                spos[b:b + 1], causal=True)
        assert torch.equal(one, o[b:b + 1]), b


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,H,KV,dh", [
    (8, 1601, 32, 8, 128),    # llama-vision's image slots: 7 splits, the last 65 wide
    (3, 300, 32, 8, 128),     # two splits, the second 44 wide
])
def test_k6_non_causal_matches_plain_and_repeats_bitwise(cuda_device, B, S, H, KV, dh,
                                                         dtype):
    """K6 with causal=False, as the xattn decode calls it over the image
    K/V: q_pos 0 (one row parked at -1, which a non-causal call ignores),
    every slot live; against the plain version (each row to its own norm),
    two launches bitwise equal, each row alone bitwise equal to it in the
    batch."""
    q, k, v, _, spos = _k6_inputs(B, S, H, KV, dh, 0, S, 0, dtype, cuda_device, S + B)
    qpos = torch.zeros((B,), dtype=torch.int32, device=cuda_device)
    qpos[1] = -1
    o = flash_decode_cuda(q, k, v, qpos, spos, causal=False)
    assert torch.equal(o, flash_decode_cuda(q, k, v, qpos, spos, causal=False))
    o_r = flash_decode_ref(q, k, v, qpos, spos, causal=False)
    torch.testing.assert_close(o.float(), o_r.float(), atol=TOL[dtype], rtol=0)
    assert _row_err(o, o_r) <= (1e-5 if dtype == "float32" else 1e-2)
    for b in range(B):
        one = flash_decode_cuda(q[b:b + 1], k[b:b + 1], v[b:b + 1], qpos[b:b + 1],
                                spos[b:b + 1], causal=False)
        assert torch.equal(one, o[b:b + 1]), b


@pytest.mark.cuda
def test_cuda_tensors_reach_the_kernels_or_raise(cuda_device):
    """ops routes CUDA tensors to the kernels (counted as such), and a
    kernel refuses what it does not take instead of falling back."""
    launches.reset()
    q = torch.randn(1, 8, 2, 16, device=cuda_device)
    k = torch.randn(1, 8, 1, 16, device=cuda_device)
    ops.flash_attention(q, k, k)
    pos = torch.arange(8, dtype=torch.int32, device=cuda_device)[None]
    ops.flash_decode(q[:, :1], k, k, torch.tensor([7], dtype=torch.int32,
                                                  device=cuda_device), pos)
    assert launches.counts() == {"flash_attention_fwd_f32": 1, "flash_decode": 1}
    ops.flash_attention(q.bfloat16(), k.bfloat16(), k.bfloat16())
    assert launches.counts()["flash_attention_fwd"] == 1   # bf16: the tensor-core route
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        ops.flash_attention(q.half(), k.half(), k.half())
    with pytest.raises(ValueError, match="int32"):
        ops.flash_decode(q[:, :1], k, k, torch.tensor([7], device=cuda_device), pos.long())
    with pytest.raises(ValueError, match="at most 256"):
        big = torch.randn(1, 4, 1, 320, device=cuda_device)
        ops.flash_attention(big, big, big)


K1_CASES = [(64, 16, 4), (512, 64, 16), (300, 200, 7), (1024, 512, 128), (100, 33, 1),
            (2048, 2048, 16), (4096, 256, 512),
            (8192, 2048, 16),    # the training slice's shape
            (300, 1003, 24)]     # n not a multiple of 8: element loads, two chunks
K2_CASES = [(64, 16, 4), (512, 48, 16), (300, 200, 7), (2048, 1024, 128), (16, 8, 1),
            (8192, 2048, 16),
            (8192, 1024, 16),    # the training slice's wk / wv shape
            (300, 203, 5)]       # m not a multiple of 8: element loads
K45_CASES = [
    # B, L, H, KV, dh, causal, window
    (1, 40, 4, 2, 16, True, 0),
    (2, 33, 4, 1, 80, True, 0),
    (1, 130, 4, 2, 128, True, 24),
    (1, 70, 2, 2, 64, False, 0),
    (1, 200, 4, 1, 120, True, 0),
    (2, 256, 16, 8, 128, True, 64),
    (2, 1100, 4, 2, 128, True, 0),    # a batch stride, L past 1024
    (1, 150, 4, 2, 32, True, 0),      # dh 32
    (1, 300, 8, 2, 112, True, 40),    # kimi's head dim, a window
    (1, 1100, 16, 1, 128, True, 0),   # MQA: G = 16 folded in K5; L not a multiple of a tile
    (2, 33, 16, 1, 16, True, 0),      # MQA at dh 16, L 33
    (2, 1030, 24, 8, 64, True, 0),    # granite's heads: G 3 folded in K5 at dh 64
    (2, 1030, 24, 24, 64, True, 0),   # musicgen's heads: MHA (G 1) at dh 64
    (1, 300, 16, 1, 256, True, 0),    # recurrentgemma's heads: G 16 at dh 256, two halves
    (1, 1030, 16, 1, 256, True, 256), # dh 256, a window, L not a multiple of a tile
    (2, 130, 4, 2, 256, False, 0),    # dh 256 non-causal, a batch stride
    (1, 100, 4, 1, 200, True, 40),    # dh in (128, 256): the tail of the second half
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,n,k", K1_CASES)
def test_k1_cuda_matches_plain(cuda_device, b, n, k, dtype):
    g = torch.Generator(device=cuda_device).manual_seed(b + n + k)
    x = _randn((b, n), g, dtype)
    x[3] = 0                                        # a zero row
    idx = torch.randperm(b, generator=g, device=cuda_device)[:k]
    c = x[idx].contiguous()
    cs, f, na = csim_argmax_cuda(x, c)
    cs_r, f_r, na_r = csim_argmax_ref(x, c)
    assert f.dtype == torch.int32 and int(f.max()) < k and int(f[3]) == 0
    torch.testing.assert_close(cs.abs(), cs_r.abs(), rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(na, na_r, rtol=1e-5, atol=1e-6)
    csim = (x.float() @ c.float().T) / (na_r.clamp_min(1e-20)[:, None]
                                        * c.float().norm(dim=1).clamp_min(1e-20))
    top2 = csim.abs().topk(min(2, k), dim=1).values
    clear = (top2[:, 0] - top2[:, -1] > 1e-4) if k > 1 else torch.ones_like(f, dtype=torch.bool)
    assert torch.equal(f[clear], f_r[clear])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,n,k", K1_CASES)
def test_k1_split_route_matches_plain_and_k1(cuda_device, b, n, k, dtype):
    """K1's split route: pass A on two column halves against its plain
    version (1e-5 of the buffer's scale, bitwise across launches); pass B
    on their sum against its plain version and, in f32, against K1 on the
    whole rows (idx equal where the top-2 margin exceeds 1e-4)."""
    from repro_torch.kernels.pamm_compress import (csim_finish_cuda, csim_finish_ref,
                                                   csim_partial_cuda, csim_partial_ref)

    g = torch.Generator(device=cuda_device).manual_seed(b + n + k + 1)
    x = _randn((b, n), g, dtype)
    x[3] = 0
    idx = torch.randperm(b, generator=g, device=cuda_device)[:k]
    c = x[idx].contiguous()
    h = max(1, n // 2)
    parts = []
    for cols in (slice(0, h), slice(h, n)):
        xs, cs_ = x[:, cols].contiguous(), c[:, cols].contiguous()
        if xs.shape[1] == 0:
            continue
        got, again, ref = csim_partial_cuda(xs, cs_), csim_partial_cuda(xs, cs_), \
            csim_partial_ref(xs, cs_)
        assert got.shape == (b, k + 1) and torch.equal(got, again)
        assert float((got - ref).abs().max()) <= 1e-5 * float(ref.abs().max()) + 1e-30
        parts.append(got)
    part = sum(parts)
    cs, f, na = csim_finish_cuda(part, idx)
    cs_r, f_r, na_r = csim_finish_ref(part, idx)
    assert f.dtype == torch.int32 and int(f[3]) == 0 and float(cs[3]) == 0
    torch.testing.assert_close(cs, cs_r, rtol=1e-6, atol=1e-7)
    torch.testing.assert_close(na, na_r, rtol=1e-6, atol=0)
    if dtype == "float32":
        cs_w, f_w, _ = csim_argmax_ref(x, c)
        torch.testing.assert_close(cs, cs_w, rtol=0, atol=1e-5)
        f_r = f_w
    csim = (x.float() @ c.float().T) / (na_r.clamp_min(1e-20)[:, None]
                                        * c.float().norm(dim=1).clamp_min(1e-20))
    top2 = csim.abs().topk(min(2, k), dim=1).values
    clear = (top2[:, 0] - top2[:, -1] > 1e-4) if k > 1 else torch.ones_like(f, dtype=torch.bool)
    assert torch.equal(f[clear], f_r[clear])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,m,k", K2_CASES)
def test_k2_cuda_matches_plain_and_is_deterministic(cuda_device, b, m, k, dtype):
    g = torch.Generator(device=cuda_device).manual_seed(b + m + k)
    f = torch.randint(0, k, (b,), generator=g, device=cuda_device, dtype=torch.int32)
    alpha = torch.randn(b, generator=g, device=cuda_device)
    gz = _randn((b, m), g, dtype)
    out = segment_matmul_cuda(f, alpha, gz, k)
    again = segment_matmul_cuda(f, alpha, gz, k)
    ref = segment_matmul_ref(f, alpha, gz, k)
    assert torch.equal(out, again)                  # bitwise, no atomics
    scale = float(ref.abs().max()) or 1.0
    torch.testing.assert_close(out, ref, rtol=0, atol=1e-5 * scale)


def _k2_fixed_splits(n):
    """A stand-in for ``pamm_apply._splits`` that fixes K2's split count at
    ``n`` (at most one a row), whatever the shapes."""
    def splits(b, m, k):
        per = -(-b // n)
        return -(-b // per), per
    return splits


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("splits", [None, 1, 3, 17, 64])
def test_k2_cuda_forced_split_counts(cuda_device, monkeypatch, splits, dtype):
    """K2 at the training slice's wk / wv shape at the rule's split count
    and at forced ones (``_splits`` swapped): each within 1e-5 of the
    output's scale and bitwise equal to itself on a second launch (another
    count may give other bits)."""
    b, m, k = 8192, 1024, 16
    if splits is not None:
        monkeypatch.setattr(pamm_apply, "_splits", _k2_fixed_splits(splits))
    g = torch.Generator(device=cuda_device).manual_seed(7)
    f = torch.randint(0, k, (b,), generator=g, device=cuda_device, dtype=torch.int32)
    alpha = torch.randn(b, generator=g, device=cuda_device)
    gz = _randn((b, m), g, dtype)
    out = segment_matmul_cuda(f, alpha, gz, k)
    again = segment_matmul_cuda(f, alpha, gz, k)
    ref = segment_matmul_ref(f, alpha, gz, k)
    assert torch.equal(out, again)
    torch.testing.assert_close(out, ref, rtol=0, atol=1e-5 * float(ref.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("b,m,k", [(2048, 1024, 16), (1000, 203, 40), (300, 64, 1)])
def test_k2_cuda_skips_rows_outside_the_generators(cuda_device, b, m, k):
    """Rows with f outside [0, k) add nothing: the kernel against the plain
    version over the other rows (index_add_ refuses such an index)."""
    g = torch.Generator(device=cuda_device).manual_seed(b + m + k)
    f = torch.randint(0, k, (b,), generator=g, device=cuda_device, dtype=torch.int32)
    f[::37] = -1
    f[5::41] = k + 3
    f[9::53] = 2**30
    alpha = torch.randn(b, generator=g, device=cuda_device)
    gz = _randn((b, m), g, "bfloat16")
    keep = (f >= 0) & (f < k)
    out = segment_matmul_cuda(f, alpha, gz, k)
    ref = segment_matmul_ref(f[keep], alpha[keep], gz[keep], k)
    assert torch.equal(out, segment_matmul_cuda(f, alpha, gz, k))
    torch.testing.assert_close(out, ref, rtol=0, atol=1e-5 * float(ref.abs().max()))


def _expert_rows(E, b, n, g, dtype):
    """x (E, b, n): expert 0 all zero, the second half of expert 1's rows
    zero (the MoE site's capacity padding)."""
    x = _randn((E, b, n), g, dtype)
    x[0] = 0
    if E > 1:
        x[1, b // 2:] = 0
    return x


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("E", [1, 3, 40])
def test_k1_batched_cuda_matches_plain(cuda_device, E, dtype):
    """The batched K1 (E 40 at the MoE site's b 2048 x n 1536, k 4) against
    its plain version, as the 2-D K1 is held; an all-zero row gives cs 0,
    index 0 and norm 0; two launches and each expert's 2-D launch give
    the same bits."""
    b, n, k = (2048, 1536, 4) if E == 40 else (1000, 200, 20)
    g = torch.Generator(device=cuda_device).manual_seed(E + n)
    x = _expert_rows(E, b, n, g, dtype)
    idx = torch.stack([torch.randperm(b, generator=g, device=cuda_device)[:k]
                       for _ in range(E)])
    c = x[torch.arange(E, device=cuda_device)[:, None], idx].contiguous()
    cs, f, na = csim_argmax_batched_cuda(x, c)
    for a, b_ in zip((cs, f, na), csim_argmax_batched_cuda(x, c)):
        assert torch.equal(a, b_)
    cs_r, f_r, na_r = csim_argmax_batched_ref(x, c)
    assert f.dtype == torch.int32 and f.shape == (E, b) and int(f.max()) < k
    assert not cs[0].any() and not f[0].any() and not na[0].any()
    torch.testing.assert_close(cs.abs(), cs_r.abs(), rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(na, na_r, rtol=1e-5, atol=1e-6)
    csim = torch.bmm(x.float(), c.float().transpose(1, 2)) / (
        na_r.clamp_min(1e-20)[..., None] * c.float().norm(dim=2).clamp_min(1e-20)[:, None])
    top2 = csim.abs().topk(min(2, k), dim=2).values
    clear = top2[..., 0] - top2[..., -1] > 1e-4
    assert torch.equal(f[clear], f_r[clear])
    for e in range(min(E, 3)):
        for a, b_ in zip((cs[e], f[e], na[e]), csim_argmax_cuda(x[e], c[e])):
            assert torch.equal(a, b_)


def _k2_fixed_batched_splits(n):
    """A stand-in for ``pamm_apply._splits_batched`` fixing K2's split count
    at ``n`` (at most one a row)."""
    def splits(e, b, m, k):
        per = -(-b // n)
        return -(-b // per), per
    return splits


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("splits", [None, 1, 3, 17])
@pytest.mark.parametrize("E", [1, 3, 40])
def test_k2_batched_cuda_matches_plain_and_is_deterministic(cuda_device, monkeypatch, E,
                                                             splits, dtype):
    """The batched K2 (E 40 at the MoE site's b 2048, k 4, m 512) against
    its plain version at the rule's split count and forced ones; two
    launches give the same bits, and so does each expert's 2-D launch at
    the same split count. Expert 0's rows are the all-zero padding (alpha
    0), expert 1's second half too."""
    b, m, k = (2048, 512, 4) if E == 40 else (1000, 203, 5)
    if splits is not None:
        monkeypatch.setattr(pamm_apply, "_splits_batched", _k2_fixed_batched_splits(splits))
    g = torch.Generator(device=cuda_device).manual_seed(E + m)
    f = torch.randint(0, k, (E, b), generator=g, device=cuda_device, dtype=torch.int32)
    alpha = torch.randn((E, b), generator=g, device=cuda_device)
    alpha[0] = 0
    if E > 1:
        alpha[1, b // 2:] = 0
        f[1, b // 2:] = 0
    gz = _randn((E, b, m), g, dtype)
    out = segment_matmul_batched_cuda(f, alpha, gz, k)
    assert out.shape == (E, k, m) and not out[0].any()
    assert torch.equal(out, segment_matmul_batched_cuda(f, alpha, gz, k))
    ref = segment_matmul_batched_ref(f, alpha, gz, k)
    torch.testing.assert_close(out, ref, rtol=0, atol=1e-5 * float(ref.abs().max()))
    nsplit, per = pamm_apply._splits_batched(E, b, m, k)
    monkeypatch.setattr(pamm_apply, "_splits", lambda b_, m_, k_: (nsplit, per))
    for e in range(min(E, 3)):
        assert torch.equal(out[e], segment_matmul_cuda(f[e], alpha[e], gz[e], k))


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["K1", "K2"])
def test_k1_k2_cuda_launch_on_the_callers_stream(cuda_device, kernel):
    """K1 and K2 launched under ``torch.cuda.stream(s)`` run on s: their
    input is written on s behind a ~30 ms sleep, so a launch on any other
    stream would read it before it is there. Only s is synchronised before
    the result is read."""
    g = torch.Generator(device=cuda_device).manual_seed(11)
    b, n, k = 4096, 1024, 16
    src = _randn((b, n), g, "bfloat16")
    f = torch.randint(0, k, (b,), generator=g, device=cuda_device, dtype=torch.int32)
    alpha = torch.randn(b, generator=g, device=cuda_device)
    c = src[torch.randperm(b, generator=g, device=cuda_device)[:k]].contiguous()
    ref = (csim_argmax_ref(src, c) if kernel == "K1"
           else segment_matmul_ref(f, alpha, src, k))
    torch.cuda.synchronize(cuda_device)
    s = torch.cuda.Stream(cuda_device)
    with torch.cuda.stream(s):
        torch.cuda._sleep(50_000_000)
        x = src.clone()
        out = csim_argmax_cuda(x, c) if kernel == "K1" else segment_matmul_cuda(f, alpha, x, k)
    s.synchronize()
    if kernel == "K1":
        torch.testing.assert_close(out[0].abs(), ref[0].abs(), rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(out[2], ref[2], rtol=1e-5, atol=1e-6)
    else:
        torch.testing.assert_close(out, ref, rtol=0, atol=1e-5 * float(ref.abs().max()))


def _check_k45(got, ref, dtype):
    """dq, dk, dv against the plain version: finite, of its dtype and shape,
    within the dtype's tolerance of each gradient's largest magnitude and
    of each row's norm."""
    tol = 1e-4 if dtype == "float32" else 2e-2
    row_tol = 1e-3 if dtype == "float32" else 1e-2
    for name, a, r in zip(("dq", "dk", "dv"), got, ref):
        assert a.dtype == r.dtype and a.shape == r.shape, name
        assert torch.isfinite(a).all(), name
        scale = float(r.float().abs().max())
        err = float((a.float() - r.float()).abs().max())
        assert err <= tol * scale, (name, err, scale)
        assert _row_err(a, r) <= row_tol, (name, _row_err(a, r))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,L,H,KV,dh,causal,window", K45_CASES)
def test_k4_k5_cuda_match_plain(cuda_device, B, L, H, KV, dh, causal, window, dtype):
    g = torch.Generator(device=cuda_device).manual_seed(L + dh + H)
    q, k, v = (_randn(s, g, dtype) for s in ((B, L, H, dh), (B, L, KV, dh), (B, L, KV, dh)))
    do = _randn((B, L, H, dh), g, dtype)
    o, lse = flash_attention_fwd_cuda(q, k, v, causal=causal, window=window)
    launches.reset()
    got = flash_attention_bwd_cuda(q, k, v, o, lse, do, causal=causal, window=window)
    sfx = "" if dtype == "bfloat16" else "_f32"     # the route of the dtype
    assert launches.counts() == {"flash_attention_dq" + sfx: 1, "flash_attention_dkv" + sfx: 1}
    ref = flash_attention_bwd_ref(q, k, v, o, lse, do, causal=causal, window=window)
    _check_k45(got, ref, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dh", [64, 120, 256])
def test_k4_k5_unaligned_rows_take_elementwise_loads(cuda_device, dh):
    """bf16 tensors whose rows are not 16-byte aligned (a one-element
    offset into their storage) go through the tensor-core route's
    element-wise loads instead of cp.async, with the same result."""
    g = torch.Generator(device=cuda_device).manual_seed(dh + 1)
    views = []
    for shape in ((1, 130, 4, dh), (1, 130, 2, dh), (1, 130, 2, dh), (1, 130, 4, dh)):
        n = torch.Size(shape).numel()
        views.append(_randn((n + 1,), g, "bfloat16")[1:].view(shape))
    q, k, v, do = views
    assert q.data_ptr() % 16 != 0
    o, lse = flash_attention_fwd_cuda(q, k, v, causal=True, window=40)
    got = flash_attention_bwd_cuda(q, k, v, o, lse, do, causal=True, window=40)
    ref = flash_attention_bwd_ref(q, k, v, o, lse, do, causal=True, window=40)
    _check_k45(got, ref, "bfloat16")


@pytest.mark.cuda
@pytest.mark.parametrize("B,L,H,KV,dh,window", [(2, 1100, 16, 8, 128, 0),
                                                (2, 1030, 24, 24, 64, 0),
                                                (1, 300, 16, 1, 80, 64),
                                                (1, 1030, 16, 1, 256, 256)])
def test_k4_k5_bf16_repeat_bitwise(cuda_device, B, L, H, KV, dh, window):
    """Two launches of the tensor-core route give the same bits: every
    output element is summed by one thread in a fixed order."""
    g = torch.Generator(device=cuda_device).manual_seed(L + dh + 2)
    q, k, v, do = (_randn(s, g, "bfloat16") for s in ((B, L, H, dh), (B, L, KV, dh),
                                                      (B, L, KV, dh), (B, L, H, dh)))
    o, lse = flash_attention_fwd_cuda(q, k, v, causal=True, window=window)
    first = flash_attention_bwd_cuda(q, k, v, o, lse, do, causal=True, window=window)
    again = flash_attention_bwd_cuda(q, k, v, o, lse, do, causal=True, window=window)
    for name, a, b in zip(("dq", "dk", "dv"), first, again):
        assert torch.equal(a, b), name


OFFSET_CASES = [
    # B, L, H, KV, dh, window, q_off, k_off: chunk pairs of a ring
    (1, 100, 4, 2, 64, 0, 300, 100),      # fully visible
    (2, 130, 4, 2, 128, 0, 130, 130),     # the diagonal at an offset, L past two tiles
    (1, 96, 8, 1, 80, 32, 96, 0),         # window edge: late rows see no key
    (1, 70, 4, 4, 16, 0, 0, 70),          # dead: the q chunk before the k chunk
    (1, 200, 16, 2, 120, 64, 400, 300),   # window edge, G 8
    (1, 256, 4, 2, 128, 256, 512, 256),   # a ring window of 256 across the seam
    (1, 200, 16, 1, 256, 64, 400, 300),   # window edge at dh 256, G 16
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,L,H,KV,dh,window,q_off,k_off", OFFSET_CASES)
def test_k3_k4_k5_offsets_cuda_match_plain(cuda_device, B, L, H, KV, dh, window, q_off,
                                           k_off, dtype):
    """The (q_off, k_off) operand: K3 (either route) on the rows that see a
    key, lse <= NEG_INF / 2 and a finite o on the rows that see none;
    K4/K5 against the merged lse a ring passes them (finite everywhere)."""
    g = torch.Generator(device=cuda_device).manual_seed(L + dh + q_off)
    q, k, v = (_randn(s, g, dtype) for s in ((B, L, H, dh), (B, L, KV, dh), (B, L, KV, dh)))
    offs = (q_off, k_off)
    o, lse = flash_attention_fwd_cuda(q, k, v, causal=True, window=window, offs=offs)
    o_r, lse_r = flash_attention_fwd_ref(q, k, v, causal=True, window=window, offs=offs)
    seen = _iota_mask(L, True, window, cuda_device, offs).any(-1)
    assert torch.isfinite(o).all()
    assert bool((lse[..., ~seen] <= NEG_INF / 2).all())
    torch.testing.assert_close(o[:, seen].float(), o_r[:, seen].float(), atol=TOL[dtype],
                               rtol=0)
    torch.testing.assert_close(lse[..., seen], lse_r[..., seen], atol=1e-3, rtol=0)
    do = _randn((B, L, H, dh), g, dtype)
    lse_m = torch.logaddexp(lse_r, torch.rand(lse_r.shape, generator=g, device=cuda_device))
    o_m = o_r.contiguous()
    got = flash_attention_bwd_cuda(q, k, v, o_m, lse_m, do, causal=True, window=window,
                                   offs=offs)
    ref = flash_attention_bwd_ref(q, k, v, o_m, lse_m, do, causal=True, window=window,
                                  offs=offs)
    _check_k45(got, ref, dtype)


@pytest.mark.cuda
def test_training_kernels_dispatch_count_and_refuse(cuda_device):
    """ops routes CUDA tensors to K1, K2, K4 and K5 (counted as such; f32
    takes the scalar route of K3, K4 and K5, bf16 the tensor-core one) and
    the backward refuses what it does not take."""
    launches.reset()
    x = torch.randn(64, 32, device=cuda_device)
    st = ops.pamm_compress(x, 4, float("inf"), torch.arange(4, device=cuda_device))
    ops.pamm_apply(st, torch.randn(64, 16, device=cuda_device))
    q = torch.randn(1, 16, 2, 16, device=cuda_device, requires_grad=True)
    kv = torch.randn(1, 16, 1, 16, device=cuda_device, requires_grad=True)
    ops.flash_attention(q, kv, kv).sum().backward()
    assert launches.counts() == {"csim_argmax": 1, "segment_matmul": 1,
                                 "flash_attention_fwd_f32": 1, "flash_attention_dq_f32": 1,
                                 "flash_attention_dkv_f32": 1}
    launches.reset()
    qb, kvb = (x.detach().bfloat16().requires_grad_() for x in (q, kv))
    ops.flash_attention(qb, kvb, kvb).float().sum().backward()
    assert launches.counts() == {"flash_attention_fwd": 1, "flash_attention_dq": 1,
                                 "flash_attention_dkv": 1}
    big = torch.randn(1, 4, 1, 264, device=cuda_device)
    lse = torch.zeros(1, 1, 4, device=cuda_device)
    with pytest.raises(ValueError, match="at most 256"):
        flash_attention_bwd_cuda(big, big, big, big, lse, big)
    with pytest.raises(ValueError, match="int32"):
        segment_matmul_cuda(st.assign.long(), st.alpha, torch.randn(64, 16, device=cuda_device), 4)


# ---------------------------------------------------------------------------
# K7 / K8: paged decode
# ---------------------------------------------------------------------------
def _paging(B, nb, ps, fill, gen, *, hole=False, ring=0):
    """Block tables of shuffled page ids (all nb blocks of a row mapped;
    ``hole`` unmaps row 0's block 1) and page_pos for ``fill[b]`` tokens,
    wrapped into a ring of nb*ps slots when ``ring``; the spare pages keep
    random stale positions."""
    dev = gen.device
    n_pages = B * nb + 3
    bt = torch.randperm(n_pages, generator=gen, device=dev)[:B * nb].reshape(B, nb)
    ppos = torch.randint(0, nb * ps, (n_pages, ps), generator=gen, device=dev)
    slots = torch.arange(nb * ps, device=dev).reshape(nb, ps)
    for b in range(B):
        n = int(fill[b])
        last = n - 1 - ((n - 1 - slots) % (nb * ps)) if ring else slots
        ppos[bt[b]] = torch.where((last >= 0) & (last < n), last, -1)
    bt = bt.to(torch.int32)
    if hole:
        bt[0, 1] = -1
    return n_pages, bt.contiguous(), ppos.to(torch.int32).contiguous()


def _seen(bt, ppos, qpos, window):
    """(B, Lq) rows that see at least one key."""
    B, nb = bt.shape
    spos = torch.where(bt[..., None] >= 0, ppos[bt.clamp_min(0).long()], -1).reshape(B, -1)
    qp = qpos[:, :, None]
    vis = (spos[:, None] >= 0) & (spos[:, None] <= qp)
    if window:
        vis &= qp - spos[:, None] < window
    return vis.any(-1)


K7_CASES = [
    # B, nb, ps, H, KV, dh, Lq, window, hole, ring
    (2, 5, 16, 4, 2, 64, 1, 0, True, 0),
    (3, 4, 64, 16, 8, 128, 1, 0, True, 0),       # the serving shape's pages
    (2, 4, 64, 16, 8, 128, 5, 0, False, 0),      # verify rows, Lq 5
    (1, 3, 8, 4, 1, 80, 5, 0, True, 0),          # head dim 80, MQA, a hole
    (2, 6, 16, 8, 2, 120, 1, 0, False, 0),       # head dim 120
    (1, 2, 64, 4, 2, 128, 1, 64, False, 300),    # ring of 128, window 64
    (2, 3, 12, 4, 4, 32, 2, 0, False, 0),        # page size 12, MHA
    (1, 4, 16, 16, 1, 256, 1, 0, False, 0),      # G = 16 rows of dh 256
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,nb,ps,H,KV,dh,Lq,window,hole,ring", K7_CASES)
def test_k7_cuda_matches_plain(cuda_device, B, nb, ps, H, KV, dh, Lq, window, hole, ring,
                               dtype):
    g = torch.Generator(device=cuda_device).manual_seed(nb * ps + dh + Lq)
    S = nb * ps
    fill = [ring] * B if ring else [S - 3 - 7 * b for b in range(B)]
    n_pages, bt, ppos = _paging(B, nb, ps, fill, g, hole=hole, ring=ring)
    q = _randn((B, Lq, H, dh), g, dtype)
    k, v = (_randn((n_pages, ps, KV, dh), g, dtype) for _ in range(2))
    qpos = (torch.tensor(fill, device=cuda_device)[:, None] - Lq
            + torch.arange(Lq, device=cuda_device)[None]).to(torch.int32)
    if B > 1:
        qpos[-1, 0] = -1                                  # a parked row
    o = flash_paged_decode_cuda(q, k, v, qpos, bt, ppos, causal=True, window=window)
    o_r = flash_paged_decode_ref(q, k, v, qpos, bt, ppos, causal=True, window=window)
    assert torch.isfinite(o).all()
    seen = _seen(bt, ppos, qpos, window)
    torch.testing.assert_close(o[seen].float(), o_r[seen].float(), atol=TOL[dtype], rtol=0)


def _fixed_splits(n):
    """A stand-in for ``flash_decode._splits`` that fixes K7's split count
    at ``n`` (at most one per table entry), whatever the shapes."""
    def splits(B, KV, nb, device):
        per = -(-nb // min(nb, n))
        return -(-nb // per), per
    return splits


K7_SPLIT_CASES = [
    # B, nb, ps, H, KV, dh, Lq, window, ring, scale, splits, empty_row
    (8, 18, 64, 16, 8, 128, 1, 0, 0, None, None, False),   # the serving shape, splits from shapes
    (2, 7, 12, 4, 2, 64, 5, 0, 0, None, 3, True),          # pages of 12: tiles straddle pages
    (2, 6, 64, 16, 8, 64, 1, 0, 0, 128 ** -0.5, 4, False), # svd rank 64 with the dh-128 scale
    (2, 8, 64, 16, 8, 128, 1, 256, 600, None, 2, False),   # a ring of 512 slots, window 256
    (1, 5, 16, 8, 2, 128, 1, 0, 0, None, 5, False),        # a page a split: the hole's has none
    (2, 9, 16, 4, 1, 256, 3, 0, 0, None, 2, False),        # dh 256 (32-key tiles), MQA
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,nb,ps,H,KV,dh,Lq,window,ring,scale,splits,empty_row",
                         K7_SPLIT_CASES)
def test_k7_splits_match_plain_and_repeat_bitwise(cuda_device, monkeypatch, B, nb, ps, H, KV,
                                                  dh, Lq, window, ring, scale, splits,
                                                  empty_row, dtype):
    """K7 split over the keys: split boundaries between pages and tile
    boundaries inside them, a split without a mapped page, a parked row,
    a row whose whole table is unmapped (o = 0, finite), Lq 5, the svd
    width, a ring window; two launches give the same bits."""
    g = torch.Generator(device=cuda_device).manual_seed(nb * ps + dh + Lq + 1)
    S = nb * ps
    fill = [ring] * B if ring else [S - 3 - 7 * b for b in range(B)]
    n_pages, bt, ppos = _paging(B, nb, ps, fill, g, hole=True, ring=ring)
    if empty_row:
        bt[1] = -1
    q = _randn((B, Lq, H, dh), g, dtype)
    k, v = (_randn((n_pages, ps, KV, dh), g, dtype) for _ in range(2))
    qpos = (torch.tensor(fill, device=cuda_device)[:, None] - Lq
            + torch.arange(Lq, device=cuda_device)[None]).to(torch.int32)
    if B > 1:
        qpos[-1, 0] = -1                                  # a parked row
    if splits is not None:
        monkeypatch.setattr(flash_decode, "_splits", _fixed_splits(splits))
    kw = dict(causal=True, window=window, scale=scale)
    o = flash_paged_decode_cuda(q, k, v, qpos, bt, ppos, **kw)
    again = flash_paged_decode_cuda(q, k, v, qpos, bt, ppos, **kw)
    o_r = flash_paged_decode_ref(q, k, v, qpos, bt, ppos, **kw)
    assert torch.equal(o, again)                          # no atomics, a fixed merge order
    assert torch.isfinite(o).all()
    if empty_row:
        assert not o[1].any()
    seen = _seen(bt, ppos, qpos, window)
    torch.testing.assert_close(o[seen].float(), o_r[seen].float(), atol=TOL[dtype], rtol=0)
    assert _row_err(o[seen], o_r[seen]) <= (1e-5 if dtype == "float32" else 1e-2)


K8_CASES = [
    # B, nb, ps, H, KV, dh, Lq, bits, ngr, hole
    (2, 4, 16, 4, 2, 64, 1, 8, 1, True),
    (2, 4, 64, 16, 8, 128, 1, 8, 4, False),      # the serving shape's pages
    (2, 4, 64, 16, 8, 128, 5, 4, 1, True),       # verify rows, int4, a hole
    (1, 3, 8, 4, 1, 128, 1, 4, 4, False),
    (2, 3, 16, 8, 2, 80, 2, 8, 5, False),        # head dim 80, 5 groups of 16
    (1, 3, 16, 8, 2, 120, 1, 4, 4, False),       # head dim 120, int4, groups of 30
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,nb,ps,H,KV,dh,Lq,bits,ngr,hole", K8_CASES)
def test_k8_cuda_matches_plain(cuda_device, B, nb, ps, H, KV, dh, Lq, bits, ngr, hole,
                               dtype):
    g = torch.Generator(device=cuda_device).manual_seed(nb * ps + dh + bits)
    S = nb * ps
    fill = [S - 3 - 7 * b for b in range(B)]
    n_pages, bt, ppos = _paging(B, nb, ps, fill, g, hole=hole)
    q = _randn((B, Lq, H, dh), g, dtype)
    w = dh if bits == 8 else dh // 2
    k, v = (torch.randint(-128, 128, (n_pages, ps, KV, w), generator=g, device=cuda_device,
                          dtype=torch.int8) for _ in range(2))
    if bits == 8:                                    # the quantiser's symmetric range
        k.clamp_(-127, 127)
        v.clamp_(-127, 127)
    ks, vs = (torch.rand((n_pages, ps, KV, ngr), generator=g, device=cuda_device) * 0.05
              for _ in range(2))
    qpos = (torch.tensor(fill, device=cuda_device)[:, None] - Lq
            + torch.arange(Lq, device=cuda_device)[None]).to(torch.int32)
    o = flash_paged_decode_quant_cuda(q, k, v, ks, vs, qpos, bt, ppos)
    o_r = flash_paged_decode_quant_ref(q, k, v, ks, vs, qpos, bt, ppos)
    assert torch.isfinite(o).all()
    seen = _seen(bt, ppos, qpos, 0)
    torch.testing.assert_close(o[seen].float(), o_r[seen].float(), atol=TOL[dtype], rtol=0)


K8_SPLIT_CASES = [
    # B, nb, ps, H, KV, dh, Lq, bits, ngr, splits
    (3, 18, 64, 16, 8, 128, 1, 8, 1, None),    # the serving pages, splits from the shapes
    (3, 18, 64, 16, 8, 128, 1, 4, 4, 18),      # a page a split: the hole's split has none
    (3, 7, 12, 4, 2, 64, 5, 8, 2, 3),          # pages of 12: tiles straddle pages, Lq 5
    (3, 5, 16, 8, 2, 80, 2, 4, 5, 2),          # int4 at dh 80: 40-byte rows, byte copies
    (3, 6, 16, 8, 2, 120, 1, 4, 4, 4),         # int4 at dh 120: 60-byte rows, groups of 30
    (3, 4, 16, 16, 1, 256, 1, 8, 2, 1),        # int8 at dh 256, MQA, one split
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,nb,ps,H,KV,dh,Lq,bits,ngr,splits", K8_SPLIT_CASES)
def test_k8_splits_match_plain_and_repeat_bitwise(cuda_device, monkeypatch, B, nb, ps, H, KV,
                                                  dh, Lq, bits, ngr, splits, dtype):
    """K8 split over the keys as K7: forced split counts, a hole, a parked
    row (finite), a row whose whole table is unmapped (o = 0), the
    unaligned int4 widths; two launches give the same bits."""
    g = torch.Generator(device=cuda_device).manual_seed(nb * ps + dh + bits + 3)
    S = nb * ps
    fill = [S - 3 - 7 * b for b in range(B)]
    n_pages, bt, ppos = _paging(B, nb, ps, fill, g, hole=True)
    bt[1] = -1                                            # no mapped page: o = 0
    q = _randn((B, Lq, H, dh), g, dtype)
    w = dh if bits == 8 else dh // 2
    k, v = (torch.randint(-127, 128, (n_pages, ps, KV, w), generator=g, device=cuda_device,
                          dtype=torch.int8) for _ in range(2))
    ks, vs = (torch.rand((n_pages, ps, KV, ngr), generator=g, device=cuda_device) * 0.05
              for _ in range(2))
    qpos = (torch.tensor(fill, device=cuda_device)[:, None] - Lq
            + torch.arange(Lq, device=cuda_device)[None]).to(torch.int32)
    qpos[-1, 0] = -1                                      # a parked row
    if splits is not None:
        monkeypatch.setattr(flash_decode, "_splits", _fixed_splits(splits))
    launches.reset()
    o = flash_paged_decode_quant_cuda(q, k, v, ks, vs, qpos, bt, ppos)
    again = flash_paged_decode_quant_cuda(q, k, v, ks, vs, qpos, bt, ppos)
    assert launches.counts() == {"flash_paged_decode_quant": 2}
    o_r = flash_paged_decode_quant_ref(q, k, v, ks, vs, qpos, bt, ppos)
    assert torch.equal(o, again)                          # no atomics, a fixed merge order
    assert torch.isfinite(o).all()
    assert not o[1].any()
    seen = _seen(bt, ppos, qpos, 0)
    torch.testing.assert_close(o[seen].float(), o_r[seen].float(), atol=TOL[dtype], rtol=0)
    assert _row_err(o[seen], o_r[seen]) <= (1e-5 if dtype == "float32" else 1e-2)


@pytest.mark.cuda
def test_paged_kernels_dispatch_scale_and_refuse(cuda_device):
    """ops routes CUDA tensors to K7 / K8 (counted as such); K7 honours a
    ``scale`` override; both refuse what they do not take, never falling
    back to a plain version."""
    g = torch.Generator(device=cuda_device).manual_seed(5)
    n_pages, bt, ppos = _paging(2, 3, 16, [40, 33], g)
    q = _randn((2, 1, 4, 64), g, "float32")
    k, v = (_randn((n_pages, 16, 2, 64), g, "float32") for _ in range(2))
    qpos = torch.tensor([39, 32], dtype=torch.int32, device=cuda_device)
    kq = torch.randint(-7, 8, (n_pages, 16, 2, 32), generator=g, device=cuda_device,
                       dtype=torch.int8)
    sc = torch.rand((n_pages, 16, 2, 2), generator=g, device=cuda_device)
    launches.reset()
    o = ops.flash_paged_decode(q, k, v, qpos, bt, ppos, scale=0.05)
    ops.flash_paged_decode_quant(q, kq, kq, sc, sc, qpos, bt, ppos)
    assert launches.counts() == {"flash_paged_decode": 1, "flash_paged_decode_quant": 1}
    torch.testing.assert_close(o, flash_paged_decode_ref(q, k, v, qpos, bt, ppos, scale=0.05),
                               atol=2e-5, rtol=0)
    with pytest.raises(ValueError, match="needs CUDA"):
        flash_paged_decode_cuda(q.cpu(), k.cpu(), v.cpu(), qpos.cpu(), bt.cpu(), ppos.cpu())
    with pytest.raises(ValueError, match="pages must be"):
        ops.flash_paged_decode(q, k.half(), v.half(), qpos, bt, ppos)
    with pytest.raises(ValueError, match="int32"):
        ops.flash_paged_decode(q, k, v, qpos.long(), bt, ppos)
    with pytest.raises(ValueError, match="pages must be"):
        ops.flash_paged_decode_quant(q, kq.float(), kq.float(), sc, sc, qpos, bt, ppos)
    odd = _randn((2, 1, 4, 65), g, "float32")
    with pytest.raises(ValueError, match="int4"):
        ops.flash_paged_decode_quant(odd, kq, kq, sc, sc, qpos, bt, ppos)
