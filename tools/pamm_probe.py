#!/usr/bin/env python3
"""Device-only times of K1 (csim arg-max) and K2 (segment sum) at
chip_smoke.py's training shapes for variant builds of their sources, and
where their wrappers spend host time. Run from the repository root on the
card:

  python3 tools/pamm_probe.py [variant ...]      (default: every variant)

Each variant is a copy of src/repro_torch/csrc under build/pamm_probe/ with
a text patch of pamm_apply.cu or pamm_compress.cu (the port's own sources
are not touched), built by repro_torch.kernels.build and timed as
chip_smoke.py times a kernel (`time_ms`: the L2 flushed before each call;
`pad=True`, the card kept busy before it, for the device-only time).
Variants (K2 at b 8192, m 2048 and 1024, k 16; K1 at b 8192, n 2048, k 16,
bf16):

  base          the sources as they are
  k2_no_merge   the split kernel alone (its output is wrong)
  k2_loads_only K2 loads every row but adds nothing (wrong output)
  k2_ldcs       dZ loaded with ld.global.cs (evict first)
  k2_ldg        dZ loaded with ld.global.nc (L1 allocates)
  k2_pdl        the merge as a programmatic dependent launch
  k2_u8, k2_u32 8 or 32 rows in flight a warp instead of 16
  k2_merge_unroll16, k2_merge128
                the merge's split loop unrolled 16 deep, or 128-thread
                merge blocks
  k2_blocks132, k2_blocks528
                the split rule aimed at 132 or 528 blocks instead of 264
  k2_w8         eight warps a block (128 KB of accumulators, one block an
                SM), the rule aimed at 132 blocks
  k1_loads_only K1 stages every tile but computes nothing (wrong output)
  k1_stages3, k1_stages6
                three or six stages instead of four
  k1_bk64       64-column stages, six deep
  k1_bk256, k1_bk256_s3
                256-column stages, four or three deep
  k1_warps2, k1_warps8
                two warps (32 rows) a block, 256 blocks; or eight (128
                rows), 64 blocks

A yardstick line times torch.sum over dZ (one read of the same bytes);
"read-flushed" lines time the yardstick and the kernels after a flush that
reads 96 MB instead of writing it, so no dirty line is written back during
the call.
The host lines time each piece of a wrapper on the host's clock over 2000
calls (the card synchronised every 100 calls).
"""
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))
import torch  # noqa: E402

from chip_smoke import _flush_buffer, time_ms  # noqa: E402
from decode_probe import use_variant  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import pamm_apply as pa  # noqa: E402
from repro_torch.kernels import pamm_compress as pc  # noqa: E402

OUT = ROOT / "build" / "pamm_probe"
K2_SRC, K1_SRC = "pamm_apply.cu", "pamm_compress.cu"
# the merge as a programmatic dependent launch: its blocks start while the
# split kernel drains and wait for it at griddepcontrol.wait
K2_PDL = [
    ("  const int t = threadIdx.x, lane = t & 31, w = t >> 5;\n",
     "  asm volatile(\"griddepcontrol.launch_dependents;\" ::: \"memory\");\n"
     "  const int t = threadIdx.x, lane = t & 31, w = t >> 5;\n"),
    ("  const long long i = (long long)blockIdx.x * MNT + threadIdx.x;\n",
     "  asm volatile(\"griddepcontrol.wait;\" ::: \"memory\");\n"
     "  const long long i = (long long)blockIdx.x * MNT + threadIdx.x;\n"),
    ("""  segment_matmul_merge<<<(unsigned)((km + MNT - 1) / MNT), MNT, 0, stream>>>(
      (const float*)part, (float*)out, nsplit, km);
  return (int)cudaGetLastError();""",
     """  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)((km + MNT - 1) / MNT));
  cfg.blockDim = dim3(MNT);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, segment_matmul_merge, (const float*)part, (float*)out,
                                 nsplit, km);"""),
]
VARIANTS = {
    "base": (None, [], {}),
    "k2_no_merge": (K2_SRC, [("if (err != cudaSuccess || nsplit == 1) return (int)err;",
                              "return (int)err;")], {}),
    "k2_loads_only": (K2_SRC, [("if (j[u] >= 0 && j[u] < kn) add_row<T>",
                                "if (j[u] >= 0 && j[u] < kn && z[u].x == 0x7fc00001u) add_row<T>")],
                      {}),
    "k2_ldcs": (K2_SRC, [("ld.global.nc.L1::no_allocate.v4.u32", "ld.global.cs.v4.u32")], {}),
    "k2_ldg": (K2_SRC, [("ld.global.nc.L1::no_allocate.v4.u32", "ld.global.nc.v4.u32")], {}),
    "k2_pdl": (K2_SRC, K2_PDL, {}),
    "k2_u8": (K2_SRC, [("constexpr int U = 16;", "constexpr int U = 8;")], {}),
    "k2_u32": (K2_SRC, [("constexpr int U = 16;", "constexpr int U = 32;")], {}),
    "k2_merge_unroll16": (K2_SRC, [("#pragma unroll 8", "#pragma unroll 16")], {}),
    "k2_merge128": (K2_SRC, [("constexpr int MNT = 256;", "constexpr int MNT = 128;")], {}),
    "k2_blocks132": (None, [], {"SPLIT_BLOCKS": 132}),
    "k2_w8": (K2_SRC, [("constexpr int W = 4;", "constexpr int W = 8;")], {"SPLIT_BLOCKS": 132}),
    "k2_blocks528": (None, [], {"SPLIT_BLOCKS": 528}),
    "k1_loads_only": (K1_SRC, [("for (int kk = 0; kk < TBK / 16; ++kk) {",
                                "for (int kk = 0; kk < 0; ++kk) {")], {}),
    "k1_stages3": (K1_SRC, [("constexpr int STAGES = 4;", "constexpr int STAGES = 3;")], {}),
    "k1_stages6": (K1_SRC, [("constexpr int STAGES = 4;", "constexpr int STAGES = 6;")], {}),
    "k1_bk64": (K1_SRC, [("constexpr int STAGES = 4;", "constexpr int STAGES = 6;"),
                         ("constexpr int TBK = 128;", "constexpr int TBK = 64;")], {}),
    "k1_bk256": (K1_SRC, [("constexpr int TBK = 128;", "constexpr int TBK = 256;")], {}),
    "k1_bk256_s3": (K1_SRC, [("constexpr int TBK = 128;", "constexpr int TBK = 256;"),
                             ("constexpr int STAGES = 4;", "constexpr int STAGES = 3;")], {}),
    "k1_warps2": (K1_SRC, [("constexpr int TW = 4;", "constexpr int TW = 2;")], {}),
    "k1_warps8": (K1_SRC, [("constexpr int TW = 4;", "constexpr int TW = 8;")], {}),
}


def read_flushed_ms(fn, flush, reps=25):
    """Median device-only time of fn after an L2 flush that reads 96 MB."""
    fn()
    times = []
    for _ in range(reps):
        torch.sum(flush, dtype=torch.int32)
        torch.cuda._sleep(1_000_000)
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return sorted(times)[reps // 2]


def host_us(fn, calls=2000):
    fn()
    torch.cuda.synchronize()
    total = 0.0
    for i in range(0, calls, 100):
        t0 = time.perf_counter()
        for _ in range(100):
            fn()
        total += time.perf_counter() - t0
        torch.cuda.synchronize()
    return 1e6 * total / calls


def main():
    if not torch.cuda.is_available():
        sys.exit("pamm_probe: needs an NVIDIA card")
    g = torch.Generator(device="cuda").manual_seed(0)
    b, n, k = 8192, 2048, 16
    x = torch.randn(b, n, device="cuda", generator=g).bfloat16()
    c = x[torch.randperm(b, device="cuda", generator=g)[:k]].contiguous()
    f = torch.randint(0, k, (b,), device="cuda", generator=g, dtype=torch.int32)
    alpha = torch.randn(b, device="cuda", generator=g)
    gz = {m: torch.randn(b, m, device="cuda", generator=g).bfloat16() for m in (2048, 1024)}
    flush = _flush_buffer()
    print(f"[probe] {torch.cuda.get_device_name(0)}; ms / device-only ms (L2 flushed)")
    for m in (2048, 1024):     # a streaming yardstick: one read of dZ
        fn = lambda: torch.sum(gz[m], dtype=torch.float32)  # noqa: E731
        print(f"[probe] torch.sum(dZ) m={m}: {time_ms(fn, flush=flush):.4f} / "
              f"{time_ms(fn, flush=flush, pad=True):.4f}", flush=True)
    # the same calls after an L2 flush that only reads (no dirty lines to
    # write back): device-only ms
    for label, fn in (("torch.sum(dZ) m=2048", lambda: torch.sum(gz[2048], dtype=torch.float32)),
                      ("K2 m=2048", lambda: pa.segment_matmul_cuda(f, alpha, gz[2048], k)),
                      ("K2 m=1024", lambda: pa.segment_matmul_cuda(f, alpha, gz[1024], k)),
                      ("K1", lambda: pc.csim_argmax_cuda(x, c))):
        print(f"[probe] read-flushed {label}: {read_flushed_ms(fn, flush):.4f}", flush=True)
    real = {"SPLIT_BLOCKS": pa.SPLIT_BLOCKS}
    names = sys.argv[1:] or list(VARIANTS)
    for name in names:
        source, patches, consts = VARIANTS[name]
        use_variant(OUT, name, source, patches)
        for key, value in consts.items():
            setattr(pa, key, value)
        if not name.startswith("k1"):
            for m in (2048, 1024):
                fn = lambda: pa.segment_matmul_cuda(f, alpha, gz[m], k)  # noqa: E731
                print(f"[probe] {name:14s} K2 m={m} ({pa._splits(b, m, k)[0]} splits): "
                      f"{time_ms(fn, flush=flush):.4f} / {time_ms(fn, flush=flush, pad=True):.4f}",
                      flush=True)
        if not name.startswith("k2"):
            fn = lambda: pc.csim_argmax_cuda(x, c)  # noqa: E731
            print(f"[probe] {name:14s} K1: {time_ms(fn, flush=flush):.4f} / "
                  f"{time_ms(fn, flush=flush, pad=True):.4f}", flush=True)
        for key, value in real.items():
            setattr(pa, key, value)

    big = torch.randn(2**29, device="cuda", generator=g).bfloat16()   # 1 GiB
    fn = lambda: torch.sum(big, dtype=torch.float32)  # noqa: E731
    print(f"[probe] torch.sum over 1 GiB: {time_ms(fn, flush=flush, pad=True):.4f} ms "
          f"device only", flush=True)
    del big

    # host time of the wrappers' pieces (the last variant's build: K2 as is)
    m = 2048
    S, per = pa._splits(b, m, k)
    entry = build.entry("segment_matmul_batched")
    out = torch.empty((k, m), device="cuda")
    part = torch.empty((S, k, m), device="cuda")
    stream = torch.cuda.current_stream(gz[m].device).cuda_stream
    args = (f.data_ptr(), alpha.data_ptr(), gz[m].data_ptr(), out.data_ptr(), part.data_ptr(),
            1, b, m, k, S, per, 1, stream)
    pieces = {
        "K2 wrapper": lambda: pa.segment_matmul_cuda(f, alpha, gz[m], k),
        "K2 _check": lambda: pa._check(f, alpha, gz[m], k),
        "K2 _splits": lambda: pa._splits(b, m, k),
        "K2 two torch.empty": lambda: (torch.empty((k, m), device=gz[m].device),
                                       torch.empty((S, k, m), device=gz[m].device)),
        "current_stream(dev).cuda_stream": lambda: torch.cuda.current_stream(
            gz[m].device).cuda_stream,
        "build.raw_stream": lambda: build.raw_stream(gz[m]),
        "K2 one torch.empty": lambda: torch.empty((S + 1) * k * m, device=gz[m].device),
        "build.entry": lambda: build.entry("segment_matmul_batched"),
        "K2 ctypes call (launches)": lambda: entry(*args),
        "K1 wrapper": lambda: pc.csim_argmax_cuda(x, c),
        "K1 _check": lambda: pc._check(x, c),
    }
    for label, fn in pieces.items():
        print(f"[probe] host {label}: {host_us(fn):.2f} us/call", flush=True)


if __name__ == "__main__":
    main()
