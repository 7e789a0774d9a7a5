#!/usr/bin/env python3
"""chip_smoke.py's rec phases alone (its ``run_rec_phases``: 22-25,
recurrentgemma's K1-K8 shapes against their plain versions,
recurrentgemma-9b served at full size and trained at a cut depth,
recurrentgemma smoke card against CPU, the rec kernel rows), after its
phase 1, for iterating on the rec path without the earlier phases. Run
from the repository root:

  python3 tools/rec_phases.py [--remat none|pamm]

``--remat`` trains the cut-depth cell under another remat mode than
chip_smoke.py's REC_REMAT. Prints what those phases print, then the rec
kernel rows as JSON; the first failure exits non-zero, as in
chip_smoke.py.
"""
import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.abspath(os.path.join(os.path.dirname(__file__), "..")))
import chip_smoke  # noqa: E402  (it puts src/ on the path)

ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
ap.add_argument("--remat", choices=("none", "pamm"), default=chip_smoke.REC_REMAT)
chip_smoke.REC_REMAT = ap.parse_args().remat
t0 = time.perf_counter()
smi, gen = chip_smoke.start()
rows = chip_smoke.run_rec_phases(gen, smi)
print(f"[done] {time.perf_counter() - t0:.1f} s")
print(json.dumps(rows))
