#!/usr/bin/env python3
"""Device-only times of the split decode kernels (K6, K7, K8 int8 / int4)
at chip_smoke.py's serving shapes, for variant builds of the shared split
body. Run from the repository root on the card:

  python3 tools/decode_probe.py

Each variant is a copy of src/repro_torch/csrc under build/decode_probe/
with a text patch of flash_decode_split.cuh (the port's own sources are
not touched), built by repro_torch.kernels.build and timed as chip_smoke.py
times a kernel (`time_ms`: the L2 flushed before each call; `pad=True`,
the card kept busy before it, for the device-only time). Variants:

  base        the sources as they are; K6 also at 128 and 512 slots a
              split, K7 / K8 also at 9 and 18 splits
  nt256       256 threads a block instead of 128
  tile32      32-key tiles at every width
  pdl         the merge launched as a programmatic dependent launch
              (griddepcontrol), so its launch overlaps the split kernel
  loads_only  the tile loop stages every tile but computes nothing (the
              outputs are wrong): the load pipeline's own time
"""
import shutil
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))
import torch  # noqa: E402

from chip_smoke import _flush_buffer, time_ms  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import flash_decode as fd  # noqa: E402

OUT = ROOT / "build" / "decode_probe"
SOURCES = build.CSRC              # the port's sources, copied for each variant
HEADER = "flash_decode_split.cuh"
PDL = [
    ("  const int sp = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;\n",
     "  asm volatile(\"griddepcontrol.launch_dependents;\" ::: \"memory\");\n"
     "  const int sp = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;\n"),
    ("  const int kvh = blockIdx.x, b = blockIdx.y;\n",
     "  asm volatile(\"griddepcontrol.wait;\" ::: \"memory\");\n"
     "  const int kvh = blockIdx.x, b = blockIdx.y;\n"),
    ("""  merge_kernel<T><<<dim3(c.KV, c.B), NT, msmem, stream>>>(c.part_acc, c.part_ml,
                                                          static_cast<T*>(c.o), c.nsplit, c.B,
                                                          c.Lq, c.H, c.KV, c.dh, c.sob, c.sol);
  return (int)cudaGetLastError();""",
     """  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(c.KV, c.B);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = msmem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, merge_kernel<T>, (const float*)c.part_acc,
                                 (const float*)c.part_ml, static_cast<T*>(c.o), c.nsplit, c.B,
                                 c.Lq, c.H, c.KV, c.dh, c.sob, c.sol);"""),
]
VARIANTS = {
    "base": [],
    "nt256": [("constexpr int NT = 128;", "constexpr int NT = 256;")],
    "tile32": [("return row_bytes <= 256 ? 64 : 32;", "return 32;")],
    "pdl": PDL,
    "loads_only": [("    // scores: (row, key) pairs",
                    "    if (true) { __syncthreads(); k0 = k1; continue; }\n"
                    "    // scores: (row, key) pairs")],
}


def use_variant(out, name, source, patches):
    """Build from here on from a copy of the port's sources under
    out/name/csrc, with each (old, new) text patch applied to the file
    ``source`` there (the port's own sources are not touched), into
    out/name/lib. Every variant is copied from the port's sources, never
    from the variant before it."""
    d = out / name / "csrc"
    if d.exists():
        shutil.rmtree(d)
    shutil.copytree(SOURCES, d)
    if patches:
        text = (d / source).read_text()
        for old, new in patches:
            if old not in text:
                raise RuntimeError(f"variant {name}: the patch no longer applies to {source}")
            text = text.replace(old, new)
        (d / source).write_text(text)
    build.CSRC, build.BUILD_DIR = d, out / name / "lib"
    build._LIBS.clear()


def fixed_splits(n):
    def splits(B, KV, nb, device):
        per = -(-nb // min(nb, n))
        return -(-nb // per), per
    return splits


def main():
    if not torch.cuda.is_available():
        sys.exit("decode_probe: needs an NVIDIA card")
    g = torch.Generator(device="cuda").manual_seed(0)
    rnd = lambda *s: torch.randn(*s, device="cuda", generator=g).bfloat16()  # noqa: E731
    B, H, KV, dh, S, nb, ps = 8, 16, 8, 128, 1089, 18, 64
    q = rnd(B, 1, H, dh)
    kc, vc = rnd(B, S, KV, dh), rnd(B, S, KV, dh)
    qpos = torch.full((B,), 1056, dtype=torch.int32, device="cuda")
    j = torch.arange(S, device="cuda", dtype=torch.int32)
    spos = torch.where(j[None] <= qpos[:, None], j[None], -1).int().contiguous()
    n_pages = B * nb + 3
    kp, vp = rnd(n_pages, ps, KV, dh), rnd(n_pages, ps, KV, dh)
    bt = torch.full((B, nb), -1, dtype=torch.int32, device="cuda")
    bt[:, :17] = torch.randperm(n_pages, device="cuda", generator=g)[:B * 17].reshape(B, 17).int()
    ppos = torch.randint(0, 1000, (n_pages, ps), device="cuda", generator=g).int()
    quant = {bits: [fd.quantize_kv(t, bits, 1) for t in (kp, vp)] for bits in (8, 4)}
    paged = {
        "K7": lambda: fd.flash_paged_decode_cuda(q, kp, vp, qpos, bt, ppos),
        "K8 int8": lambda: fd.flash_paged_decode_quant_cuda(
            q, quant[8][0][0], quant[8][1][0], quant[8][0][1], quant[8][1][1], qpos, bt, ppos),
        "K8 int4": lambda: fd.flash_paged_decode_quant_cuda(
            q, quant[4][0][0], quant[4][1][0], quant[4][0][1], quant[4][1][1], qpos, bt, ppos),
    }
    flush = _flush_buffer()
    real_splits, real_per = fd._splits, fd.DENSE_SPLIT_KEYS
    print(f"[probe] {torch.cuda.get_device_name(0)}; device-only ms (L2 flushed)")
    for name, patches in VARIANTS.items():
        use_variant(OUT, name, HEADER, patches)
        for per in (real_per, 128, 512) if name == "base" else (real_per,):
            fd.DENSE_SPLIT_KEYS = per
            fn = lambda: fd.flash_decode_cuda(q, kc, vc, qpos, spos)  # noqa: E731
            print(f"[probe] {name:10s} K6 {per} slots a split: "
                  f"{time_ms(fn, flush=flush, pad=True):.4f}", flush=True)
        fd.DENSE_SPLIT_KEYS = real_per
        for n in (None, 9, 18) if name == "base" else (None,):
            fd._splits = real_splits if n is None else fixed_splits(n)
            for label, fn in paged.items():
                print(f"[probe] {name:10s} {label} {n or 'shape'} splits: "
                      f"{time_ms(fn, flush=flush, pad=True):.4f}", flush=True)
        fd._splits = real_splits


if __name__ == "__main__":
    main()
