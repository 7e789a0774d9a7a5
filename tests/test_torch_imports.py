"""The port stands alone: ``repro_torch`` and ``chip_smoke.py`` import
neither JAX nor anything of the JAX package ``repro``; and every C entry
point the ctypes bindings declare exists in its CUDA source with the
declared number of arguments."""
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
    for m in ("repro_torch.serve.engine", "repro_torch.bridge", "repro_torch.launch.train",
              "repro_torch.train.train_step", "repro_torch.optim.optimizers",
              "repro_torch.core.pamm", "repro_torch.core.keys", "repro_torch.core.policies",
              "repro_torch.kernels.pamm_compress", "repro_torch.kernels.pamm_apply",
              "repro_torch.serve.router", "repro_torch.train.serve_step"):
        assert m in mods, m
    code = (
        "import importlib, json, sys\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "import chip_smoke\n"
        "chip_smoke.bound(1.0, 1.0); chip_smoke.k3_work(1, 8, 2, 1, 16, causal=True, "
        "window=0, itemsize=2)\n"
        "chip_smoke.k1_work(64, 16, 4, 2); chip_smoke.k2_work(64, 16, 4, 2)\n"
        "chip_smoke.k45_work(1, 8, 2, 1, 16, causal=True, window=0, itemsize=2, which='K5')\n"
        "chip_smoke.NumpySampler().choice(0, (('fold_in', 1),), 10, 3, 'cpu')\n"
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


def test_every_c_entry_point_exists_with_its_arity():
    """build.SIGNATURES against the sources: each entry point is an
    ``extern "C"`` function of its source file, taking as many arguments as
    its ctypes argtypes declare (nothing here can compile the sources)."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build

    assert set(build.SOURCES) == {p.stem for p in (PORT / "csrc").glob("*.cu")}
    for name, argtypes in build.SIGNATURES.items():
        text = (PORT / "csrc" / f"{build.SOURCE_OF.get(name, name)}.cu").read_text()
        m = re.search(r'extern "C" int ' + name + r"\(([^)]*)\)", text)
        assert m, name
        assert len(m.group(1).split(",")) == len(argtypes), name
