"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Every test here needs an NVIDIA GPU and skips without one; the
module imports no JAX, so it runs where only torch is installed:

  PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py -q

Tolerances: f32 atol 2e-5 on o (the same f32 math summed in another
order); bf16 atol 5e-2 on o (both round o to bf16); lse atol 1e-3.
"""
import pytest
import torch

from repro_torch.kernels import launches, ops
from repro_torch.kernels.flash_attention import (flash_attention_fwd_cuda,
                                                 flash_attention_fwd_ref)
from repro_torch.kernels.flash_decode import flash_decode_cuda, flash_decode_ref

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
]
K6_CASES = [
    # B, S, H, KV, dh, window, n_valid
    (2, 64, 4, 2, 64, 0, 64),
    (1, 96, 4, 1, 32, 0, 50),
    (2, 37, 8, 2, 80, 0, 37),
    (1, 16, 2, 2, 128, 8, 16),
    (3, 300, 16, 1, 256, 0, 260),     # G = 16 rows of dh 256
    (2, 129, 8, 8, 112, 0, 100),      # MHA, S past two tiles
]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _randn(shape, gen, dtype):
    return torch.randn(shape, generator=gen, device=gen.device).to(getattr(torch, dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,L,H,KV,dh,causal,window", K3_CASES)
def test_k3_cuda_matches_plain(cuda_device, B, L, H, KV, dh, causal, window, dtype):
    g = torch.Generator(device=cuda_device).manual_seed(L + dh)
    q, k, v = (_randn(s, g, dtype) for s in ((B, L, H, dh), (B, L, KV, dh), (B, L, KV, dh)))
    o, lse = flash_attention_fwd_cuda(q, k, v, causal=causal, window=window)
    o_r, lse_r = flash_attention_fwd_ref(q, k, v, causal=causal, window=window)
    assert o.dtype == q.dtype and lse.dtype == torch.float32
    torch.testing.assert_close(o.float(), o_r.float(), atol=TOL[dtype], rtol=0)
    torch.testing.assert_close(lse, lse_r, atol=1e-3, rtol=0)


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
    assert launches.counts() == {"flash_attention_fwd": 1, "flash_decode": 1}
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        ops.flash_attention(q.half(), k.half(), k.half())
    with pytest.raises(ValueError, match="int32"):
        ops.flash_decode(q[:, :1], k, k, torch.tensor([7], device=cuda_device), pos.long())
    with pytest.raises(ValueError, match="at most 256"):
        big = torch.randn(1, 4, 1, 320, device=cuda_device)
        ops.flash_attention(big, big, big)
