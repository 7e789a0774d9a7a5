#!/usr/bin/env python3
"""Drive the PyTorch port's dense-cache serving slice on one NVIDIA H100.

  python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch/csrc`` with nvcc,
holds each against its plain PyTorch version on the card, serves
internlm2-1.8b at full width through the continuous-batching engine, and
prints what it measured. Phases, in order; the first failure exits
non-zero and no phase is caught and ignored:

  1. device and build   nvidia-smi's name and power limit, torch/CUDA
                        versions, one nvcc per kernel source in parallel
  2. K3 vs plain        prefill flash attention, bf16: internlm2's prefill
                        shape, a sliding window, head dims 80 and 120
  3. K6 vs plain        flash decode, bf16: 8 slots x 1089, a parked row,
                        a ring cache, head dims 80 and 120
  4. serving            internlm2-1.8b (24 layers, d 2048, 16/8 heads,
                        vocab 92544), bf16, random weights from seed 0,
                        8 slots, 16 requests of ~1024 prompt tokens and 64
                        new tokens (12 greedy, 4 at temperature 0.8 /
                        top-k 40): every request finishes, logits stay
                        finite, a second run gives the same tokens, greedy
                        requests give the same tokens alone, the launch
                        counts show K3 and K6 carried the attention, and
                        decode tokens agree with a teacher-forced prefill;
                        then torch.profiler splits one prefill and one
                        decode block by kernel and gives the idle share
  5. numbers            throughput, latency, kernel times next to their
                        plain versions, SDPA and the data-sheet bound

The line before the last is the JSON kernel table; the last line is
``{"ok": true, "device": {...}}``. Without a CUDA device the script exits
non-zero and prints no result. It imports nothing of JAX or of the JAX
package.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# NVIDIA H100 SXM data sheet (dense, 700 W): the bound's denominators
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_S = 3.35e12
ARCH = "internlm2-1.8b"
SLOTS, MAX_LEN, DECODE_BLOCK = 8, 1089, 8
PROMPT_LEN, N_REQUESTS, GEN = 1024, 16, 64
SAMPLED = {3, 7, 11, 15}          # uids served at temperature 0.8 / top-k 40
TOL_O = 2e-2                       # bf16 outputs: a few bf16 ulps at |o| <= 1
TOL_LSE = 1e-3                     # f32 lse from the same bf16 inputs
K3_SOURCE = "src/repro_torch/csrc/flash_attention_fwd.cu"
K6_SOURCE = "src/repro_torch/csrc/flash_decode.cu"
K3_REPLACES = "src/repro/kernels/flash_attention.py:263"
K6_REPLACES = "src/repro/kernels/flash_decode.py:147"
# substrings of cuBLAS / CUTLASS matrix-product kernel names on Hopper
GEMM_NAMES = ("gemm", "gemv", "cutlass", "xmma", "cublas", "nvjet")


def fail(msg: str) -> None:
    print(f"chip_smoke FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def bound(flops: float, nbytes: float) -> tuple[float, str]:
    """Least time (ms) for the work on the card: the larger of bytes over
    the memory rate and operations over the bf16 peak."""
    t_ops, t_mem = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES_S
    return (1e3 * max(t_ops, t_mem), "operations" if t_ops >= t_mem else "bytes")


def k3_work(B, L, H, KV, dh, *, causal: bool, window: int, itemsize: int):
    """(flops, bytes) of one K3 call: 4*dh per visible (query, key) pair
    and head; q, k, v read once, o and lse written once."""
    pairs = 0
    for i in range(L):
        lo = max(0, i - window + 1) if window > 0 else 0
        hi = i + 1 if causal else L
        pairs += max(0, hi - lo)
    flops = 4.0 * dh * pairs * H * B
    nbytes = B * L * (2 * H + 2 * KV) * dh * itemsize + B * H * L * 4
    return flops, nbytes


def k6_work(q_pos, slot_pos, H, KV, dh, *, window: int, itemsize: int):
    """(flops, bytes) of one K6 call on this data: the K/V rows of the
    slots each query can see (read once), q, o, the positions."""
    qp = q_pos[:, None]
    live = (slot_pos >= 0) & (slot_pos <= qp)
    if window > 0:
        live &= qp - slot_pos < window
    n_live = int(live.sum())
    B, S = slot_pos.shape
    flops = 4.0 * dh * n_live * H
    nbytes = (2 * n_live * KV * dh * itemsize + 2 * B * H * dh * itemsize
              + (B * S + B) * 4)
    return flops, nbytes


def time_ms(fn, reps: int = 25, warmup: int = 3, flush=None) -> float:
    """Median CUDA-event time of ``fn`` over ``reps`` calls, each after an
    L2 flush (the caller in the serving loop finds its inputs cold)."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        if flush is not None:
            flush.zero_()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def ring_slot_pos(B, S, n_tokens, device):
    """slot_pos of a ring of S slots after writing positions 0..n-1."""
    import torch

    j = torch.arange(S, device=device)
    last = n_tokens - 1 - ((n_tokens - 1 - j) % S)
    return torch.where(last >= 0, last, -1).to(torch.int32).expand(B, S).contiguous()


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------
def phase_device_and_build():
    import torch

    from repro_torch.kernels import build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(f"[device] {smi}")
    print(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]} | {torch.cuda.get_device_name(0)} "
          f"x{torch.cuda.device_count()}")
    t0 = time.perf_counter()
    libs = build.build()
    print(f"[build] {len(libs)} kernels built/found in {time.perf_counter() - t0:.1f} s")
    for name, path in libs.items():
        log = path.with_suffix(".log")
        for line in (log.read_text().splitlines() if log.exists() else []):
            if "registers" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}")
    return smi


def _randn(shape, gen, dtype=None):
    import torch

    return torch.randn(shape, generator=gen, device="cuda").to(dtype or torch.bfloat16)


def phase_k3(gen):
    from repro_torch.kernels.flash_attention import (flash_attention_fwd_cuda,
                                                     flash_attention_fwd_ref)

    cases = [(1, 1024, 16, 8, 128, 0), (1, 1024, 16, 8, 128, 256),
             (1, 1000, 16, 8, 80, 0), (1, 1000, 16, 8, 120, 0)]
    worst = 0.0
    for B, L, H, KV, dh, window in cases:
        q = _randn((B, L, H, dh), gen)
        k = _randn((B, L, KV, dh), gen)
        v = _randn((B, L, KV, dh), gen)
        o, lse = flash_attention_fwd_cuda(q, k, v, causal=True, window=window)
        o_r, lse_r = flash_attention_fwd_ref(q, k, v, causal=True, window=window)
        e_o = (o.float() - o_r.float()).abs().max().item()
        e_l = (lse - lse_r).abs().max().item()
        print(f"[K3] B={B} L={L} H={H} KV={KV} dh={dh} window={window}: "
              f"max|o-o_ref|={e_o:.3e} (tol {TOL_O}) max|lse-lse_ref|={e_l:.3e} "
              f"(tol {TOL_LSE})")
        check(bool(o.isfinite().all()) and e_o <= TOL_O and e_l <= TOL_LSE,
              f"K3 disagrees with its plain version at {(B, L, H, KV, dh, window)}")
        worst = max(worst, e_o)
    return worst


def phase_k6(gen):
    import torch

    from repro_torch.kernels.flash_decode import flash_decode_cuda, flash_decode_ref

    B, S, H, KV = SLOTS, MAX_LEN, 16, 8
    worst = 0.0
    fills = torch.tensor([S - 97 * b for b in range(B)], device="cuda")
    for dh, ring in ((128, False), (128, True), (80, False), (120, False)):
        Sx = 256 if ring else S
        window = 256 if ring else 0
        q = _randn((B, 1, H, dh), gen)
        k = _randn((B, Sx, KV, dh), gen)
        v = _randn((B, Sx, KV, dh), gen)
        if ring:
            n = 600
            spos = ring_slot_pos(B, Sx, n, "cuda")
            qpos = torch.full((B,), n - 1, dtype=torch.int32, device="cuda")
        else:
            j = torch.arange(Sx, device="cuda")
            spos = torch.where(j[None, :] < fills[:, None], j[None, :], -1).to(torch.int32)
            qpos = (fills - 1).to(torch.int32)
        qpos[3] = -1                                   # a parked slot
        o = flash_decode_cuda(q, k, v, qpos, spos, causal=True, window=window)
        o_r = flash_decode_ref(q, k, v, qpos, spos, causal=True, window=window)
        e = (o.float() - o_r.float()).abs().max().item()
        print(f"[K6] B={B} S={Sx} H={H} KV={KV} dh={dh} window={window} "
              f"(row 3 parked): max|o-o_ref|={e:.3e} (tol {TOL_O})")
        check(bool(o.isfinite().all()), "K6 output of a parked row is not finite")
        check(e <= TOL_O, f"K6 disagrees with its plain version at dh={dh} ring={ring}")
        worst = max(worst, e)
    return worst


def _requests(cfg):
    from repro_torch.launch.serve import _build_requests
    from repro_torch.serve import SamplingParams

    args = argparse.Namespace(prompt_len=PROMPT_LEN, requests=N_REQUESTS, gen=GEN,
                              temperature=0.0, top_k=0, seed=0)
    reqs = _build_requests(cfg, args)
    for r in reqs:
        if r.uid in SAMPLED:
            r.sampling = SamplingParams(temperature=0.8, top_k=40, seed=r.uid)
    return reqs


def phase_serving():
    import torch

    from repro_torch.configs import RunConfig, get_config
    from repro_torch.kernels import launches
    from repro_torch.models import init_model
    from repro_torch.serve import ServeEngine

    cfg = get_config(ARCH)
    rcfg = RunConfig(compute_dtype="bfloat16", param_dtype="bfloat16", policy_name="none")
    t0 = time.perf_counter()
    model = init_model(cfg, rcfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"[serve] {ARCH}: {n_params / 1e9:.3f} B params (bf16) initialised on the "
          f"card in {time.perf_counter() - t0:.1f} s")
    engine = lambda: ServeEngine(cfg, rcfg, model, max_slots=SLOTS, max_len=MAX_LEN,
                                 decode_block=DECODE_BLOCK)

    warm = engine().run(_requests(cfg))               # warm-up (cuBLAS, allocator)
    torch.cuda.reset_peak_memory_stats()
    launches.reset()
    eng = engine()
    out = eng.run(_requests(cfg))                      # the measured main path
    torch.cuda.synchronize()
    counts = launches.counts()
    stats = eng.stats()
    peak = torch.cuda.max_memory_allocated()

    check(sorted(out) == list(range(N_REQUESTS)), "not every request finished")
    check(all(len(out[u].tokens) == GEN for u in out), "a request did not get 64 tokens")
    check(stats["nonfinite_logits"] == 0,
          f"{stats['nonfinite_logits']} non-finite logits rows")
    check(all(out[u].tokens == warm[u].tokens for u in out),
          "a second run gave different tokens")
    n_layers = cfg.n_layers
    print(f"[serve] launches {counts} | prefills {stats['prefill_count']} | "
          f"decode steps {stats['decode_steps']}")
    check(counts.get("flash_attention_fwd", 0) == n_layers * stats["prefill_count"],
          "K3 launches != 24 x prefills")
    check(counts.get("flash_decode", 0) == n_layers * stats["decode_steps"],
          "K6 launches != 24 x decode steps")
    check(counts.get("flash_attention_fwd_ref", 0) == 0
          and counts.get("flash_decode_ref", 0) == 0,
          "a plain version ran on the main path")
    for uid in (0, 1):                                 # greedy, alone
        req = [r for r in _requests(cfg) if r.uid == uid]
        solo = engine().run(req)[uid]
        check(solo.tokens == out[uid].tokens,
              f"greedy request {uid} alone differs from its batched run")
    print(f"[serve] 16/16 requests x {GEN} tokens; second run identical; greedy "
          f"requests 0 and 1 identical alone and batched; logits finite")
    check_against_prefill(cfg, rcfg, model, _requests(cfg)[0], out[0].tokens)
    trace_breakdown(cfg, engine, model, {
        "prefill": 1e3 * stats["prefill_s"] / max(1, stats["prefill_count"]),
        "decode block": 1e3 * stats["decode_s"] / max(1, stats["decode_steps"]) * DECODE_BLOCK})
    return counts, stats, peak


def check_against_prefill(cfg, rcfg, model, req, tokens, every: int = 8):
    """The engine's greedy tokens (K3 prefill, then K6 decode steps) against
    the argmax of a fresh prefill over prompt + tokens[:t] (K3 only), as
    the JAX serving tests hold their engine to a teacher-forced forward.
    Where the argmax differs, the two bf16 paths must be at a near tie:
    the prefill's top-2 margin below 0.25 (logits are O(10); bf16 keeps
    ~3 significant digits through 24 layers)."""
    import torch

    from repro_torch.models import prefill

    worst, n_diff = 0.0, 0
    for t in range(0, len(tokens), every):
        seq = torch.tensor([list(req.tokens) + tokens[:t]], device="cuda")
        logits, _ = prefill(cfg, rcfg, model, {"tokens": seq}, seq.shape[1])
        row = logits[0, -1, : cfg.vocab_size]
        check(bool(torch.isfinite(row).all()), "non-finite prefill logits")
        if int(row.argmax()) != tokens[t]:
            top2 = row.topk(2).values
            margin = float(top2[0] - top2[1])
            n_diff, worst = n_diff + 1, max(worst, margin)
            check(margin < 0.25, f"decode token {t} disagrees with prefill argmax "
                                 f"at a margin of {margin:.3f}")
    print(f"[serve] request 0: decode tokens vs teacher-forced prefill argmax at "
          f"{len(range(0, len(tokens), every))} positions: {n_diff} near-tie "
          f"differences (largest top-2 margin {worst:.4f})")


def trace_breakdown(cfg, engine, model, unprofiled_ms: dict):
    """Device time by kernel group over one prefill and one decode block
    (torch.profiler), and the device's busy share of the same work's wall
    time in the measured main-path run (``unprofiled_ms``; the profiler's
    own host overhead inflates the wall time it sees)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    eng = engine()
    reqs = _requests(cfg)[:SLOTS]
    for slot, req in enumerate(reqs[1:], start=1):
        eng.insert(eng.prefill(model, req), eng.decode_state, slot)
    torch.cuda.synchronize()
    for label, work in (("prefill", lambda: eng.insert(eng.prefill(model, reqs[0]),
                                                       eng.decode_state, 0)),
                        ("decode block", lambda: eng.generate(model, eng.decode_state))):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            work()
            torch.cuda.synchronize()
            wall_ms = 1e3 * (time.perf_counter() - t0)
        groups: dict[str, float] = {}
        others: dict[str, float] = {}
        for evt in prof.key_averages():
            # device-side entries only: a CPU op (aten::mm) carries its
            # kernels' time too, and counting both would count it twice
            us = getattr(evt, "self_device_time_total", 0) or 0
            if evt.device_type != DeviceType.CUDA or us <= 0:
                continue
            name = evt.key
            group = ("K3" if "fwd_kernel" in name else "K6" if "decode_kernel" in name
                     else "GEMM" if any(s in name.lower() for s in GEMM_NAMES)
                     else "other")
            groups[group] = groups.get(group, 0.0) + us / 1e3
            if group == "other":
                others[name] = us / 1e3
        busy = sum(groups.values())
        if busy == 0:
            print(f"[trace] {label}: device time not measured (the profiler recorded "
                  f"no device activity); wall {wall_ms:.2f} ms")
            continue
        parts = " | ".join(f"{g} {ms:.3f} ms" for g, ms in
                           sorted(groups.items(), key=lambda kv: -kv[1]))
        base = unprofiled_ms[label]
        print(f"[trace] {label}: device busy {busy:.3f} ms of {base:.2f} ms unprofiled "
              f"wall ({100 * busy / base:.1f}% busy, {100 - 100 * busy / base:.1f}% idle; "
              f"{wall_ms:.2f} ms under the profiler) | {parts}")
        top = sorted(others.items(), key=lambda kv: -kv[1])[:4]
        print(f"[trace] {label}: largest other kernels: "
              + " | ".join(f"{ms:.3f} ms {name[:60]}" for name, ms in top))


def _kernel_row(name, source, replaces, launches, err, fn, plain, lib, work):
    flush = _flush_buffer()
    ms = time_ms(fn, flush=flush)
    plain_ms = time_ms(plain, reps=20, flush=flush)
    lib_ms = time_ms(lib, flush=flush)
    bms, by = bound(*work)
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bms, "bound_by": by, "library_ms": lib_ms}


_FLUSH = []


def _flush_buffer():
    import torch

    if not _FLUSH:
        _FLUSH.append(torch.empty(96 * 2**20, dtype=torch.uint8, device="cuda"))
    return _FLUSH[0]


def phase_numbers(gen, counts, stats, smi, err3, err6, peak):
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import (flash_attention_fwd_cuda,
                                                     flash_attention_fwd_ref)
    from repro_torch.kernels.flash_decode import flash_decode_cuda, flash_decode_ref

    # K3 at the slice's prefill shape
    B, L, H, KV, dh = 1, PROMPT_LEN, 16, 8, 128
    q, k, v = _randn((B, L, H, dh), gen), _randn((B, L, KV, dh), gen), _randn((B, L, KV, dh), gen)
    kx, vx = (t.repeat_interleave(H // KV, dim=2).transpose(1, 2) for t in (k, v))
    qt = q.transpose(1, 2)
    k3 = _kernel_row(
        "flash_attention_fwd (K3)", K3_SOURCE, K3_REPLACES,
        counts.get("flash_attention_fwd", 0), err3,
        lambda: flash_attention_fwd_cuda(q, k, v, causal=True),
        lambda: flash_attention_fwd_ref(q, k, v, causal=True),
        lambda: F.scaled_dot_product_attention(qt, kx, vx, is_causal=True),
        k3_work(B, L, H, KV, dh, causal=True, window=0, itemsize=2))

    # K6 at the slice's decode shape: 8 slots of 1089, mid-generation
    B, S = SLOTS, MAX_LEN
    q = _randn((B, 1, H, dh), gen)
    kc, vc = _randn((B, S, KV, dh), gen), _randn((B, S, KV, dh), gen)
    qpos = torch.full((B,), PROMPT_LEN + GEN // 2, dtype=torch.int32, device="cuda")
    j = torch.arange(S, device="cuda", dtype=torch.int32)
    spos = torch.where(j[None, :] <= qpos[:, None], j[None, :], -1).to(torch.int32)
    mask = ((spos >= 0) & (spos <= qpos[:, None]))[:, None, None, :]
    kx, vx = (t.repeat_interleave(H // KV, dim=2).transpose(1, 2) for t in (kc, vc))
    qt = q.transpose(1, 2)
    k6 = _kernel_row(
        "flash_decode (K6)", K6_SOURCE, K6_REPLACES, counts.get("flash_decode", 0), err6,
        lambda: flash_decode_cuda(q, kc, vc, qpos, spos, causal=True),
        lambda: flash_decode_ref(q, kc, vc, qpos, spos, causal=True),
        lambda: F.scaled_dot_product_attention(qt, kx, vx, attn_mask=mask),
        k6_work(qpos, spos, H, KV, dh, window=0, itemsize=2))

    tag = f"[{smi}]"
    for row in (k3, k6):
        print(f"[numbers] {row['name']}: {row['ms']:.4f} ms/call | plain "
              f"{row['plain_ms']:.4f} ms | SDPA {row['library_ms']:.4f} ms | bound "
              f"{row['bound_ms']:.4f} ms ({row['bound_by']}) | {row['launches']} "
              f"launches on the main path {tag}")
    from repro_torch.configs import get_config

    n_layers = get_config(ARCH).n_layers
    step_ms = 1e3 * stats["decode_s"] / max(1, stats["decode_steps"])
    prefill_ms = 1e3 * stats["prefill_s"] / max(1, stats["prefill_count"])
    print(f"[numbers] prefill {stats['prefill_tok_s']:.1f} tok/s "
          f"({prefill_ms:.2f} ms per {PROMPT_LEN}-token prefill; K3 x{n_layers} = "
          f"{n_layers * k3['ms']:.2f} ms of it) {tag}")
    print(f"[numbers] decode {stats['decode_tok_s']:.1f} tok/s | p50 "
          f"{stats['p50_token_latency_ms']:.3f} ms | p95 "
          f"{stats['p95_token_latency_ms']:.3f} ms per step | {step_ms:.3f} ms per "
          f"step, K6 x{n_layers} = {n_layers * k6['ms']:.3f} ms of it {tag}")
    print(f"[numbers] peak torch.cuda.max_memory_allocated {peak / 2**30:.3f} GiB "
          f"| kv capacity {stats['cache/kv_capacity_mb']:.1f} MiB {tag}")
    return [k3, k6]


def main() -> int:
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs an NVIDIA card")
    if not (ROOT / "src" / "repro_torch").is_dir():
        fail(f"the repro_torch package is not next to {Path(__file__).name}")
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    smi = phase_device_and_build()
    gen = torch.Generator(device="cuda").manual_seed(1234)
    err3 = phase_k3(gen)
    err6 = phase_k6(gen)
    counts, stats, peak = phase_serving()
    kernels = phase_numbers(gen, counts, stats, smi, err3, err6, peak)
    print(f"[done] {time.perf_counter() - t0:.1f} s")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
