#!/usr/bin/env python3
"""chip_smoke.py's ssm phases alone (its ``run_ssm_phases``: 18-21, K1 / K2
at the ssm.in site's shapes against their plain versions, mamba2-370m
served and trained, mamba2 smoke card against CPU, the ssm kernel rows),
after its phase 1, for iterating on the ssm path without the earlier
phases. Run from the repository root:

  python3 tools/ssm_phases.py

Prints what those phases print, then the ssm kernel rows as JSON; the
first failure exits non-zero, as in chip_smoke.py.
"""
import json
import os
import sys
import time

sys.path.insert(0, os.path.abspath(os.path.join(os.path.dirname(__file__), "..")))
import chip_smoke  # noqa: E402  (it puts src/ on the path)

t0 = time.perf_counter()
smi, gen = chip_smoke.start()
rows = chip_smoke.run_ssm_phases(gen, smi)
print(f"[done] {time.perf_counter() - t0:.1f} s")
print(json.dumps(rows))
