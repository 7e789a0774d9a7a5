#!/usr/bin/env python3
"""chip_smoke.py's mesh phases alone (its ``run_mesh_phases``: 35-39, the
ring's K3 / K4 / K5 at its chunk shape against their plain versions,
internlm2-1.8b trained on data 2, context 2 and data 2 x context 2 gloo
ranks sharing the card against the single-process step, the ring's
kernel rows), after its phase 1, for iterating on the mesh path without
the earlier phases; and the same checks run against planted faults, to
show that they can fail. Run from the repository root:

  python3 tools/mesh_phases.py [--kernels-only | --layers N]
                               [--keep-going] [--plant-fault NAME ...]

``--kernels-only`` stops after phase 35; ``--layers N`` sets the data and
context phases' depth (default ``chip_smoke.MESH_LAYERS``, 4 of 24; 0 for
full depth; their checks then use N). Prints what those phases print, then the kernel rows as
JSON; the first failure exits non-zero, as in chip_smoke.py, unless
``--keep-going``: then every failing check is printed, the phases go on,
and the exit is non-zero at the end.

``--plant-fault NAME`` (repeatable; ``all`` for every one) runs phases 36
and 37 (at ``--layers``) once for each fault, planted in every rank, with
every check run, and expects the check that ``FAULTS`` names to be among
those that fail: it prints ``[planted] NAME caught by: ...``, or exits
non-zero when that check passed.
"""
import argparse
import functools
import json
import os
import sys
import time

sys.path.insert(0, os.path.abspath(os.path.join(os.path.dirname(__file__), "..")))
import chip_smoke  # noqa: E402  (it puts src/ on the path)

# name: (the fault, words of the failure message that must catch it)
FAULTS = {
    "skip_gather": ("the ZeRO-1 gather is skipped: each rank keeps the other "
                    "ranks' slices of every split leaf stale",
                    "the parameters' change parts"),
    "no_feedback": ("the int8_ef all-reduce zeroes the residues before it "
                    "quantises: no error feedback",
                    "does not follow error feedback"),
    "dkv_not_home": ("the ring's backward rotates k and v but leaves dk and dv "
                     "on the rank that computed them",
                     "the mesh's gradients part"),
}


def plant(fault: str) -> None:
    """Plant ``fault`` in this process's repro_torch modules."""
    from repro_torch.kernels import ring_attention
    from repro_torch.train import distributed

    if fault == "skip_gather":
        distributed.gather_shards_ = lambda *args, **kw: None
    elif fault == "no_feedback":
        compressed = distributed.tree_compressed_psum

        def no_feedback(grads, err, *args):
            for e in err.values():
                e.zero_()
            return compressed(grads, err, *args)

        distributed.tree_compressed_psum = no_feedback
    elif fault == "dkv_not_home":
        shift = ring_attention.ring_shift

        def kv_only(tensors, ring):
            if len(tensors) == 4:           # the backward's k, v, dk, dv
                return list(shift(tensors[:2], ring)) + list(tensors[2:])
            return shift(tensors, ring)

        ring_attention.ring_shift = kv_only
    else:
        raise ValueError(f"unknown fault {fault!r}; have {sorted(FAULTS)}")


def planted_rank(rank: int, world: int, jobs: list, fault: str) -> list:
    plant(fault)
    return chip_smoke.mesh_rank(rank, world, jobs)


class Failures(list):
    """Stands in for chip_smoke.fail: a failing check is printed and kept,
    and the phases go on."""

    def __call__(self, msg: str) -> None:
        print(f"[check failed] {msg}", flush=True)
        self.append(msg)


def run_planted(smi, faults, layers) -> bool:
    """Phases 36-37 once per fault, every check run; True when each fault
    failed the check that FAULTS names (others may fail too)."""
    ok = True
    for fault in faults:
        what, want = FAULTS[fault]
        print(f"[planted] {fault}: {what}; expected to fail: '{want}'", flush=True)
        chip_smoke.fail = failures = Failures()
        chip_smoke.phase_mesh_pair(smi, layers, functools.partial(planted_rank, fault=fault))
        hit = [m for m in failures if want in m]
        ok &= bool(hit)
        print(f"[planted] {fault} " + (f"caught by: {hit[0]}" if hit else
                                       "NOT CAUGHT by its check") +
              f" ({len(failures)} checks failed in all)", flush=True)
    return ok


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernels-only", action="store_true")
    ap.add_argument("--layers", type=int, default=chip_smoke.MESH_LAYERS)
    ap.add_argument("--plant-fault", action="append", default=[],
                    choices=sorted(FAULTS) + ["all"])
    ap.add_argument("--keep-going", action="store_true",
                    help="print every failing check and go on; exit 1 at the end")
    args = ap.parse_args()
    t0 = time.perf_counter()
    smi, gen = chip_smoke.start()
    if args.plant_fault:
        faults = sorted(FAULTS) if "all" in args.plant_fault else args.plant_fault
        ok = run_planted(smi, faults, args.layers or None)
        print(f"[done] {time.perf_counter() - t0:.1f} s")
        sys.exit(0 if ok else 1)
    if args.kernels_only:
        print(json.dumps(chip_smoke.phase_ring_kernels(gen)))
        return
    if args.keep_going:
        chip_smoke.fail = Failures()
    rows = chip_smoke.run_mesh_phases(gen, smi, layers=args.layers or None)
    print(f"[done] {time.perf_counter() - t0:.1f} s")
    print(json.dumps(rows))
    if args.keep_going and chip_smoke.fail:
        sys.exit(1)


if __name__ == "__main__":   # the ranks re-import this file: run nothing then
    main()
