"""The PyTorch port stands alone: importing any of its modules pulls in
neither JAX nor the reference package, and no source file names either."""
import os
import re
import subprocess
import sys
from pathlib import Path

SRC = Path(__file__).resolve().parents[1] / "src"
PORT = SRC / "repro_torch"

PROBE = r"""
import importlib, pkgutil, sys
import repro_torch
mods = ["repro_torch"]
for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
    importlib.import_module(m.name)
    mods.append(m.name)
bad = sorted(k for k in sys.modules
             if k == "jax" or k.startswith("jax.") or k == "jaxlib"
             or k == "repro" or k.startswith("repro."))
print(len(mods), bad)
assert not bad, bad
"""


def test_import_pulls_in_neither_jax_nor_reference():
    env = dict(os.environ, PYTHONPATH=str(SRC))
    r = subprocess.run([sys.executable, "-c", PROBE], env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    n_mods = int(r.stdout.split()[0])
    assert n_mods >= 20          # every module of the port was imported


def test_no_source_file_imports_jax_or_reference():
    pat = re.compile(r"^\s*(import\s+(jax|repro)\b(?!_)|"
                     r"from\s+(jax|repro)\b(?!_))", re.M)
    files = sorted(PORT.rglob("*.py"))
    assert files
    offenders = [str(f.relative_to(SRC)) for f in files
                 if pat.search(f.read_text())]
    assert offenders == []
