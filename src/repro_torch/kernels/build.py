"""Build the port's CUDA kernels with ``nvcc`` and bind them with ctypes.

Each ``csrc/<name>.cu`` exposes plain C entry points (SIGNATURES; most
sources hold one entry point of their own name) and compiles, on first
use, into ``build/repro_torch_kernels/<name>-<hash>.so`` at the
repository root (the hash covers the source text, the shared headers
``csrc/*.cuh`` and the flags, so an edited source rebuilds and a stale
library is never loaded). No PyTorch header is included, which keeps one
build to seconds.

Nothing here runs at import time: the CPU tests import every module of
the port on a machine with neither ``nvcc`` nor a card.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

P, I, LL, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
# argtypes of each C entry point; an entry point lives in ``csrc/<name>.cu``
# unless SOURCE_OF names another source
SIGNATURES = {
    # K3, two routes of one signature: flash_attention_fwd (bf16, tensor
    # cores) and flash_attention_fwd_f32 (f32, scalar). q k v o lse,
    # B L H KV dh, strides (q b,l  k b,l  v b,l  o b,l), causal window
    # q_off k_off scale stream
    "flash_attention_fwd": [P] * 5 + [I] * 5 + [LL] * 8 + [I] * 4 + [F, P],
    "flash_attention_fwd_f32": [P] * 5 + [I] * 5 + [LL] * 8 + [I] * 4 + [F, P],
    # q k v q_pos slot_pos o part_acc part_ml, B S H KV dh nsplit per,
    # strides (q b; k b,s; v b,s; slot_pos b; o b), causal window scale
    # dtype stream
    "flash_decode": [P] * 8 + [I] * 7 + [LL] * 7 + [I, I, F, I, P],
    # K1 and K2 over E problems (the MoE site's experts; E 1 for one):
    # x c cs idx norm, E b n k, dtype stream; f alpha gz out part, E b m k
    # nsplit per, dtype stream
    "csim_argmax_batched": [P] * 5 + [I] * 5 + [P],
    # K1's split route: pass A x c part, b n k dtype stream; pass B part
    # gen_rows cs idx norm, b k stream
    "csim_partial": [P] * 3 + [I] * 4 + [P],
    "csim_finish": [P] * 5 + [I] * 2 + [P],
    "segment_matmul_batched": [P] * 5 + [I] * 7 + [P],
    # K4, two routes of one signature: flash_attention_dq (bf16, tensor
    # cores) and flash_attention_dq_f32 (f32, scalar). q k v do lse delta
    # dq, B L H KV dh, strides (q b,l  k b,l  v b,l  do b,l  dq b,l),
    # causal window q_off k_off scale stream
    "flash_attention_dq": [P] * 7 + [I] * 5 + [LL] * 10 + [I] * 4 + [F, P],
    "flash_attention_dq_f32": [P] * 7 + [I] * 5 + [LL] * 10 + [I] * 4 + [F, P],
    # K5, likewise flash_attention_dkv and flash_attention_dkv_f32. q k v
    # do lse delta dk dv, B L H KV dh, strides (q b,l  k b,l  v b,l  do b,l
    # dk b,l  dv b,l), causal window q_off k_off scale stream
    "flash_attention_dkv": [P] * 8 + [I] * 5 + [LL] * 12 + [I] * 4 + [F, P],
    "flash_attention_dkv_f32": [P] * 8 + [I] * 5 + [LL] * 12 + [I] * 4 + [F, P],
    # q k_pages v_pages q_pos block_table page_pos o part_acc part_ml,
    # B Lq H KV dh ps nb nsplit pps, strides (q b,l  k page,off  v page,off
    # block_table b  page_pos page  o b,l), causal window scale dtype stream
    "flash_paged_decode": [P] * 9 + [I] * 9 + [LL] * 10 + [I, I, F, I, P],
    # q k_pages v_pages k_scale v_scale q_pos block_table page_pos o
    # part_acc part_ml, B Lq H KV dh ps nb ngr bits nsplit pps, strides (q
    # b,l  k page,off  v page,off  k_scale page,off  v_scale page,off
    # block_table b  page_pos page  o b,l), causal window scale dtype stream
    "flash_paged_decode_quant": [P] * 11 + [I] * 11 + [LL] * 14 + [I, I, F, I, P],
}
SOURCE_OF = {
    "flash_attention_fwd_f32": "flash_attention_fwd",
    "csim_argmax_batched": "pamm_compress",
    "csim_partial": "pamm_compress",
    "csim_finish": "pamm_compress",
    "segment_matmul_batched": "pamm_apply",
    "flash_attention_dq": "flash_attention_bwd",
    "flash_attention_dkv": "flash_attention_bwd",
    "flash_attention_dq_f32": "flash_attention_bwd",
    "flash_attention_dkv_f32": "flash_attention_bwd",
    "flash_paged_decode_quant": "flash_paged_decode",
}
SOURCES = tuple(dict.fromkeys(SOURCE_OF.get(e, e) for e in SIGNATURES))

_LIBS: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    found = shutil.which("nvcc") or str(Path(home) / "bin" / "nvcc")
    if not Path(found).exists():
        raise RuntimeError(
            "nvcc not found (looked on PATH and in $CUDA_HOME/bin): the "
            "CUDA kernels are built from src/repro_torch/csrc on first use")
    return found


def _target(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):     # the shared headers
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names=None) -> dict[str, Path]:
    """Compile every named source (default: all of SOURCES) whose library is missing, one ``nvcc``
    per source, all started together. Returns name -> library path.
    Raises with the compiler's output if any build fails; the compiler
    log (``-Xptxas -v``: registers, shared memory, spills) is kept next
    to each library as ``<lib>.log``."""
    names = list(SOURCES) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    targets = {n: _target(n) for n in names}
    procs = {}
    for n, out in targets.items():
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        procs[n] = (subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), tmp)
    failed = []
    for n, (proc, tmp) in procs.items():
        log, _ = proc.communicate()
        targets[n].with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"--- nvcc {n}.cu (exit {proc.returncode}) ---\n{log}")
        else:
            tmp.replace(targets[n])
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return targets


def entry(name: str):
    """The C entry point ``name`` (a key of SIGNATURES), with its argtypes
    set; its source is built and loaded on first use."""
    source = SOURCE_OF.get(name, name)
    lib = _LIBS.get(source)
    if lib is None:
        lib = ctypes.CDLL(str(build([source])[source]))
        _LIBS[source] = lib
    fn = getattr(lib, name)
    if fn.argtypes is None:
        fn.argtypes = SIGNATURES[name]
        fn.restype = ctypes.c_int
    return fn


def raw_stream(t) -> int:
    """The handle of the current CUDA stream on tensor ``t``'s device, as
    the C entry points take it (K1's and K2's wrappers read it here). torch's
    raw-stream accessor (the one its compiled Triton launchers call) costs
    about 4 us less host time a call than
    ``torch.cuda.current_stream(device).cuda_stream``, which builds a Stream
    object (tools/pamm_probe.py). It is private to torch: the card test
    ``test_k1_k2_cuda_launch_on_the_callers_stream`` holds it to the stream
    that ``torch.cuda.stream(s)`` sets."""
    return torch._C._cuda_getCurrentRawStream(t.get_device())


def check_launch(name: str, err: int) -> None:
    """Raise if a C entry point reported a CUDA error for its launch."""
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError {err}")
