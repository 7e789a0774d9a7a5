#!/usr/bin/env python3
"""chip_smoke.py's audio phases alone (its ``run_audio_phases``: 30-34,
musicgen's kernels at 24 / 24 heads of 64 against their plain versions,
musicgen-medium scored and decoded over embeddings at full size, musicgen
smoke card against CPU and musicgen-medium trained at full size, the
port's examples on the card, the audio kernel rows), after its phase 1,
for iterating on the audio path without the earlier phases. Run from the
repository root:

  python3 tools/audio_phases.py [--kernels-only]

``--kernels-only`` stops after phase 30 (the kernels against their plain
versions). Prints what those phases print, then the audio kernel rows as
JSON; the first failure exits non-zero, as in chip_smoke.py.
"""
import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.abspath(os.path.join(os.path.dirname(__file__), "..")))
import chip_smoke  # noqa: E402  (it puts src/ on the path)

ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
ap.add_argument("--kernels-only", action="store_true")
args = ap.parse_args()
t0 = time.perf_counter()
smi, gen = chip_smoke.start()
if args.kernels_only:
    print(json.dumps(chip_smoke.phase_audio_kernels(gen)))
else:
    rows = chip_smoke.run_audio_phases(gen, smi)
    print(f"[done] {time.perf_counter() - t0:.1f} s")
    print(json.dumps(rows))
