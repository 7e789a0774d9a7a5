#!/usr/bin/env python3
"""chip_smoke.py's vision phases alone (its ``run_vision_phases``: 26-29,
K6 non-causal and the attn.cross_kv site's K1 / K2 against their plain
versions, llama-3.2-vision-11b served at full size and trained at a cut
depth, vision smoke card against CPU, the vision kernel rows), after its
phase 1, for iterating on the vision path without the earlier phases. Run
from the repository root:

  python3 tools/vision_phases.py [--kernels-only]

``--kernels-only`` stops after phase 26 (the kernels against their plain
versions). Prints what those phases print, then the vision kernel rows as
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
    print(json.dumps(chip_smoke.phase_vision_kernels(gen)))
else:
    rows = chip_smoke.run_vision_phases(gen, smi)
    print(f"[done] {time.perf_counter() - t0:.1f} s")
    print(json.dumps(rows))
