#!/usr/bin/env python3
"""Which collectives gloo takes on CUDA tensors, on one card, and what
they cost against the same collective on pinned host buffers.

Two gloo ranks on cuda:0 (``repro_torch.launch.ranks``) try each
operation the mesh executor uses -- all_reduce, all_gather, broadcast,
send / recv (batch_isend_irecv), reduce_scatter -- on CUDA tensors as
they are, check the values, and time a 256 MiB all_reduce and
send / recv both ways: on the CUDA tensor (where gloo takes it) and
through a pinned host buffer (copy out, collective, copy back); and the
all_reduce as four 64 MiB pieces in flight at once, and an all_gather. Why
``runtime/collectives.py`` stages the ring's send / recv through host
buffers, and hands all_reduce / all_gather to gloo as they are, comes
from here.
Run from the repository root:

  python3 tools/gloo_probe.py

Prints the card's name and power limit, one line per operation as it is
tried, the times, and a JSON object last.
"""
import json
import os
import subprocess
import sys
import time
import traceback

sys.path.insert(0, os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src")))

MIB = 2**20


def _try(name, fn):
    try:
        ok = bool(fn())
        return {"op": name, "ok": ok, "error": None if ok else "wrong values"}
    except Exception:                       # noqa: BLE001 -- the probe reports every refusal
        return {"op": name, "ok": False, "error": traceback.format_exc().splitlines()[-1]}


def probe(rank, world):
    import torch
    import torch.distributed as dist

    dev = torch.device("cuda", 0)
    peer = 1 - rank
    out = []

    def all_reduce():
        t = torch.full((1024,), float(rank + 1), device=dev)
        dist.all_reduce(t)
        return bool((t == 3.0).all())

    def all_gather():
        t = torch.full((1024,), float(rank), device=dev)
        got = [torch.empty_like(t) for _ in range(world)]
        dist.all_gather(got, t)
        return all(bool((g == r).all()) for r, g in enumerate(got))

    def broadcast():
        t = torch.full((1024,), float(rank + 5), device=dev)
        dist.broadcast(t, 0)
        return bool((t == 5.0).all())

    def send_recv():
        t = torch.full((1024,), float(rank), device=dev)
        r = torch.empty_like(t)
        for req in dist.batch_isend_irecv([dist.P2POp(dist.isend, t, peer),
                                           dist.P2POp(dist.irecv, r, peer)]):
            req.wait()
        torch.cuda.synchronize()
        return bool((r == peer).all())

    def reduce_scatter():
        t = torch.full((2048,), float(rank + 1), device=dev)
        r = torch.empty(1024, device=dev)
        dist.reduce_scatter_tensor(r, t)
        return bool((r == 3.0).all())

    def run(name, fn):
        out.append(_try(name, fn))
        if rank == 0:
            print(f"[gloo] {name} on CUDA tensors: {'taken' if out[-1]['ok'] else 'refused'}"
                  + ("" if out[-1]["ok"] else f" ({out[-1]['error']})"), flush=True)
        dist.barrier()

    for name, fn in (("all_reduce", all_reduce), ("all_gather", all_gather),
                     ("broadcast", broadcast)):
        run(name, fn)

    big = torch.ones(256 * MIB // 4, device=dev)
    host = torch.empty(big.numel(), pin_memory=True)
    back = torch.empty_like(big)

    def timed(fn, reps=3):
        fn()
        dist.barrier()
        ts = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ts.append(1e3 * (time.perf_counter() - t0))
        return sorted(ts)[len(ts) // 2]

    def staged_all_reduce():
        host.copy_(big, non_blocking=True)
        torch.cuda.synchronize()
        dist.all_reduce(host)
        big.copy_(host)

    def staged_send_recv():
        host.copy_(big, non_blocking=True)
        torch.cuda.synchronize()
        r = torch.empty_like(host)
        for req in dist.batch_isend_irecv([dist.P2POp(dist.isend, host, peer),
                                           dist.P2POp(dist.irecv, r, peer)]):
            req.wait()
        back.copy_(r)

    quarters = big.view(4, -1).unbind(0)

    def async_quarters():
        for w in [dist.all_reduce(q, async_op=True) for q in quarters]:
            w.wait()

    times = {"all_reduce staged": timed(staged_all_reduce),
             "send_recv staged": timed(staged_send_recv)}
    if out[0]["ok"]:
        times["all_reduce on the CUDA tensor"] = timed(lambda: dist.all_reduce(big))
        times["all_reduce 4 x 64 MiB async on the CUDA tensor"] = timed(async_quarters)
        gathered = [torch.empty_like(big) for _ in range(world)]
        times["all_gather on the CUDA tensor"] = timed(lambda: dist.all_gather(gathered, big))
    print(f"[gloo] rank {rank}, 256 MiB f32, ms (median of 3, two ranks sharing one card): "
          + ", ".join(f"{k} {v:.1f}" for k, v in times.items()), flush=True)
    # last: an operation gloo does not take on CUDA may fail in its own
    # threads and end the process, after the lines above are out
    for name, fn in (("reduce_scatter", reduce_scatter), ("send_recv", send_recv)):
        run(name, fn)
    return {"ops": out, "ms_256MiB": times}


def main():
    import torch

    from repro_torch.launch.ranks import run_ranks

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(smi)
    try:
        res = run_ranks(2, probe, timeout=300)
    except RuntimeError as e:
        # a refused operation that ended its rank: the lines printed so far stand
        print(f"[gloo] the probe's ranks ended early: {str(e).splitlines()[0]}")
        sys.exit(1)
    print(json.dumps({"ops": res[0]["ops"], "ms_256MiB": [r["ms_256MiB"] for r in res]}))


if __name__ == "__main__":
    main()
