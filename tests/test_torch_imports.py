"""The port stands alone: ``repro_torch`` and ``chip_smoke.py`` import
neither JAX nor anything of the JAX package ``repro``."""
import json
import os
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
IMPORT_RE = re.compile(r"^\s*(?:from|import)\s+(jax\w*|repro)(?:\.|\s|$)", re.M)


def _port_modules() -> list[str]:
    mods = []
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(PORT.parent).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        mods.append(".".join(parts))
    return mods


def test_importing_the_port_loads_no_jax_and_no_repro():
    mods = _port_modules()
    assert "repro_torch.serve.engine" in mods and "repro_torch.bridge" in mods
    code = (
        "import importlib, json, sys\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "import chip_smoke\n"
        "chip_smoke.bound(1.0, 1.0); chip_smoke.k3_work(1, 8, 2, 1, 16, causal=True, "
        "window=0, itemsize=2)\n"
        "print(json.dumps(sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, check=True, timeout=120)
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_no_source_imports_jax_or_repro():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    offenders = {}
    for path in files:
        hits = IMPORT_RE.findall(path.read_text())
        if hits:
            offenders[str(path.relative_to(ROOT))] = hits
    assert offenders == {}
    # the scan itself sees what it must refuse, and lets the port through
    assert IMPORT_RE.findall("import jax.numpy as jnp\nfrom repro.models import x\n") \
        == ["jax", "repro"]
    assert IMPORT_RE.findall("from repro_torch.models import x\nimport repro_torch\n") == []
