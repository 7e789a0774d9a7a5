#!/usr/bin/env python3
"""chip_smoke.py's tensor-parallel phases alone (its ``run_tp_phases``:
43-45, internlm2-1.8b trained over the model axis on two gloo ranks
sharing the card and on data 2 x model 2, against the single-process
step; K1-K5 at a model rank's shapes as kernel rows; and its
``run_split_and_expert_phases``: 46-48, K1's split route against its
plain versions, internlm2 with a compressed ffn.down and granite-moe with
its experts over the model axis, each on two ranks against the
single-process step, and their kernel rows; and its
``run_kind_tp_phases``: 49-51, mamba2-370m and a recurrentgemma-9b unit
over the model axis on two ranks, mamba2 on data 2 x model 2, each
against the single-process step, and K1 / K2 / K3-K5 at a model rank's
shapes as kernel rows; and its ``run_xar_tp_phases``: 52-55, one
llama-3.2-vision-11b unit, musicgen-medium at 12 layers and reversible
internlm2-1.8b at 4 layers (f32) over the model axis on two ranks, each
against the single-process step, and K1 / K2 / K3-K5 at a model rank's
shapes as kernel rows), after its phase 1, for iterating on tensor
parallelism without the earlier phases; and the same checks run against
planted faults, to show that they can fail. Run from the repository root:

  python3 tools/tp_phases.py [--phases 43-45|46-48|43-48|49-51|52-55]
                             [--layers N] [--dtp-layers N] [--split-layers N]
                             [--ep-layers N] [--ssm-layers N]
                             [--ssm-dtp-layers N] [--ssm-f32-layers N]
                             [--audio-layers N] [--rev-layers N]
                             [--keep-going]
                             [--plant-fault NAME ...]

``--phases`` picks the phases (43-45 by default). ``--layers N`` cuts
phase 43 to N layers, ``--dtp-layers N`` phase 44, ``--split-layers N``
phase 47, ``--ep-layers N`` phase 48, ``--ssm-layers N`` phase 49's model-2
job, ``--ssm-f32-layers N`` its f32 job (full depth by default) and
``--ssm-dtp-layers N`` its data x model job, ``--audio-layers N`` phase
53 and ``--rev-layers N`` phase 54 (a quick rehearsal of the path; their
checks then use N). Prints what those phases print, then
the kernel rows as JSON; the first failure exits non-zero, as in
chip_smoke.py, unless ``--keep-going``: then every failing check is
printed, the phases go on, and the exit is non-zero at the end.

``--plant-fault NAME`` (repeatable; ``all`` for every one) runs the phases
its ``FAULTS`` entry names -- 43 and 44 (at ``--layers`` /
``--dtp-layers``), or 49 or 50 (at ``--ssm-layers``; no data x model
job) -- once for each fault, planted in every rank, with every check run,
and expects the check that ``FAULTS`` names to be among those that fail:
it prints ``[planted] NAME caught by: ...``, or exits non-zero when that
check passed.
"""
import argparse
import functools
import json
import os
import sys
import time

sys.path.insert(0, os.path.abspath(os.path.join(os.path.dirname(__file__), "..")))
import chip_smoke  # noqa: E402  (it puts src/ on the path)

# name: (the fault, words of the failure message that must catch it, the
# phases it runs: "43-44", or the job of phase 49 / 50)
FAULTS = {
    "no_column_sum": ("the column-parallel input's backward keeps this rank's part of "
                      "the gradient (no all-reduce over the model group)",
                      "the mesh's gradients part", "43-44"),
    "no_row_sum": ("the row-parallel output is not summed over the model group",
                   "the mesh's losses part", "43-44"),
    # at random initialisation the norm moves the losses by ~1e-4 only
    "norm_local": ("the ssm out_norm's sum of squares is not summed over the model "
                   "group (each rank normalises by its own columns)",
                   "the mesh's gradients part", "49"),
    # B / C and lambda are a few per cent of the gradients' norm: the ranks'
    # updates of them part, and the whole leaves' copies with them
    "bc_unsummed": ("Mamba-2's B / C columns, whole on every rank, keep each rank's part "
                    "of their gradient", "the model ranks' copies of the whole leaf", "49"),
    "lambda_unsummed": ("RG-LRU's whole lambda keeps each rank's part of its gradient",
                        "the model ranks' copies of the whole leaf", "50"),
}


def plant(fault: str) -> None:
    """Plant ``fault`` in this process's repro_torch modules."""
    from repro_torch.models import rglru, ssm
    from repro_torch.runtime import collectives

    if fault == "no_column_sum":
        collectives._CopyToModel.backward = staticmethod(lambda ctx, g: (g, None))
    elif fault == "no_row_sum":
        collectives._ReduceFromModel.forward = staticmethod(lambda ctx, x, mg: x.clone())
    elif fault == "norm_local":
        ssm.model_sum = lambda t, mg: t
    elif fault == "bc_unsummed":
        ssm.copy_cols_to_model = lambda w, mg, start, stop: w
    elif fault == "lambda_unsummed":
        rglru.copy_to_model = lambda t, mg: t
    else:
        raise ValueError(f"unknown fault {fault!r}; have {sorted(FAULTS)}")


def planted_rank(rank: int, world: int, jobs: list, fault: str) -> list:
    plant(fault)
    return chip_smoke.tp_rank(rank, world, jobs)


class Failures(list):
    """Stands in for chip_smoke.fail: a failing check is printed and kept,
    and the phases go on."""

    def __call__(self, msg: str) -> None:
        print(f"[check failed] {msg}", flush=True)
        self.append(msg)


def run_planted(smi, faults, layers, dtp_layers, ssm_layers) -> bool:
    """The fault's phases once per fault, every check run; True when each
    fault failed the check that FAULTS names (others may fail too)."""
    ok = True
    real = chip_smoke.tp_rank
    jobs = {"49": {**chip_smoke.SSM_TP_JOB, "layers": ssm_layers},
            "50": chip_smoke.REC_TP_JOB}
    for fault in faults:
        what, want, phases = FAULTS[fault]
        print(f"[planted] {fault}: {what}; expected to fail: '{want}'", flush=True)
        chip_smoke.fail = failures = Failures()
        chip_smoke.tp_rank = functools.partial(planted_rank, fault=fault)
        try:
            if phases == "43-44":
                chip_smoke.phase_tensor_parallel(smi, layers, dtp_layers)
            else:
                chip_smoke.phase_kind_tensor_parallel(smi, (jobs[phases],), 0)
        finally:
            chip_smoke.tp_rank = real
        hit = [m for m in failures if want in m]
        ok &= bool(hit)
        print(f"[planted] {fault} " + (f"caught by: {hit[0]}" if hit else
                                       "NOT CAUGHT by its check") +
              f" ({len(failures)} checks failed in all)", flush=True)
    return ok


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--layers", type=int, default=chip_smoke.TP_LAYERS)
    ap.add_argument("--dtp-layers", type=int, default=chip_smoke.DTP_LAYERS)
    ap.add_argument("--plant-fault", action="append", default=[],
                    choices=sorted(FAULTS) + ["all"])
    ap.add_argument("--keep-going", action="store_true",
                    help="print every failing check and go on; exit 1 at the end")
    ap.add_argument("--phases", choices=("43-45", "46-48", "43-48", "49-51", "52-55"),
                    default="43-45")
    ap.add_argument("--split-layers", type=int, default=chip_smoke.SPLIT_LAYERS)
    ap.add_argument("--ep-layers", type=int, default=chip_smoke.EP_LAYERS)
    ap.add_argument("--ssm-layers", type=int, default=chip_smoke.SSM_TP_LAYERS)
    ap.add_argument("--ssm-dtp-layers", type=int, default=chip_smoke.SSM_DTP_LAYERS)
    ap.add_argument("--ssm-f32-layers", type=int, default=None)
    ap.add_argument("--audio-layers", type=int, default=chip_smoke.AUDIO_TP_LAYERS)
    ap.add_argument("--rev-layers", type=int, default=chip_smoke.REV_TP_LAYERS)
    args = ap.parse_args()
    t0 = time.perf_counter()
    smi, gen = chip_smoke.start()
    if args.plant_fault:
        faults = sorted(FAULTS) if "all" in args.plant_fault else args.plant_fault
        ok = run_planted(smi, faults, args.layers, args.dtp_layers, args.ssm_layers)
        print(f"[done] {time.perf_counter() - t0:.1f} s")
        sys.exit(0 if ok else 1)
    if args.keep_going:
        chip_smoke.fail = Failures()
    rows = []
    if args.phases == "49-51":
        jobs = ({**chip_smoke.SSM_TP_JOB, "layers": args.ssm_layers},
                {**chip_smoke.SSM_TP_F32_JOB, "layers": args.ssm_f32_layers},
                chip_smoke.REC_TP_JOB)
        rows += chip_smoke.run_kind_tp_phases(gen, smi, jobs, args.ssm_dtp_layers)
    if args.phases == "52-55":
        vision, audio, rev = chip_smoke.XAR_TP_JOBS
        jobs = (vision, {**audio, "layers": args.audio_layers},
                {**rev, "layers": args.rev_layers})
        rows += chip_smoke.run_xar_tp_phases(gen, smi, jobs)
    if args.phases in ("43-45", "43-48"):
        rows += chip_smoke.run_tp_phases(gen, smi, args.layers, args.dtp_layers)[0]
    if args.phases in ("46-48", "43-48"):
        split, ep = (dict(job) for job in chip_smoke.SPLIT_JOBS)
        split["layers"], ep["layers"] = args.split_layers, args.ep_layers
        rows += chip_smoke.run_split_and_expert_phases(gen, smi, (split, ep))[0]
    print(f"[done] {time.perf_counter() - t0:.1f} s")
    print(json.dumps(rows))
    if args.keep_going and chip_smoke.fail:
        sys.exit(1)


if __name__ == "__main__":   # the ranks re-import this file: run nothing then
    main()
