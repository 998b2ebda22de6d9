"""The PyTorch port stands alone: importing any of its modules pulls in
neither JAX nor the reference package, and no source file names either;
the same holds for the port's examples (``examples/torch_*.py``)."""
import os
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"
PORT = SRC / "repro_torch"
IMPORT = re.compile(r"^\s*(import\s+(jax|repro)\b(?!_)|"
                    r"from\s+(jax|repro)\b(?!_))", re.M)

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
print(len(mods), bad, " ".join(mods))
assert not bad, bad
"""


def test_import_pulls_in_neither_jax_nor_reference():
    env = dict(os.environ, PYTHONPATH=str(SRC))
    r = subprocess.run([sys.executable, "-c", PROBE], env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    n_mods = int(r.stdout.split()[0])
    assert n_mods >= 20          # every module of the port was imported
    # the telemetry and the async frontend among them
    mods = set(r.stdout.split("]", 1)[1].split())
    assert {"repro_torch.obs", "repro_torch.obs.metrics",
            "repro_torch.obs.trace", "repro_torch.obs.slowlog",
            "repro_torch.reach.frontend", "repro_torch.reach.frontend.loop",
            "repro_torch.reach.frontend.router",
            "repro_torch.reach.frontend.cache",
            "repro_torch.reach.frontend.stats",
            "repro_torch.core.distributed",
            "repro_torch.runtime.fault_tolerance",
            "repro_torch.data.graph_data",
            "repro_torch.checkpoint.checkpoint",
            "repro_torch.configs.phi35_moe",
            "repro_torch.configs.moonshot_v1_16b",
            "repro_torch.parallel",
            "repro_torch.parallel.collectives",
            "repro_torch.parallel.sharding",
            "repro_torch.parallel.pipeline",
            "repro_torch.launch.mesh",
            "repro_torch.optim.compression",
            "repro_torch.runtime.elastic"} <= mods


def test_no_source_file_imports_jax_or_reference():
    files = sorted(PORT.rglob("*.py"))
    assert files
    offenders = [str(f.relative_to(SRC)) for f in files
                 if IMPORT.search(f.read_text())]
    assert offenders == []


def test_chip_smoke_imports_neither_jax_nor_reference():
    """The card's smoke run holds to the port's rule: no import of jax or
    of the reference anywhere in it (its imports of the port sit inside
    functions), and importing it pulls in neither."""
    script = ROOT / "chip_smoke.py"
    assert IMPORT.findall(script.read_text()) == []
    probe = (f"import sys; sys.path.insert(0, {str(ROOT)!r}); "
             "import chip_smoke; bad = sorted(k for k in sys.modules if "
             "k.split('.')[0] in ('jax', 'jaxlib', 'repro')); "
             "assert not bad, bad")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    r = subprocess.run([sys.executable, "-c", probe], env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


EXAMPLE_PROBE = r"""
import importlib.util, sys
for path in sys.argv[1:]:
    spec = importlib.util.spec_from_file_location("example", path)
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
bad = sorted(k for k in sys.modules
             if k.split(".")[0] in ("jax", "jaxlib", "repro"))
assert not bad, bad
print(len(sys.argv) - 1)
"""


def test_examples_import_neither_jax_nor_reference():
    """The port's eight examples name neither jax nor the reference, and
    importing them (their ``__main__`` blocks aside) pulls in neither."""
    files = sorted((ROOT / "examples").glob("torch_*.py"))
    assert [f.name for f in files] == [
        "torch_gnn_train.py", "torch_lm_train.py",
        "torch_moe_expert_parallel.py", "torch_quickstart.py",
        "torch_reachability_serve.py", "torch_sharded_cells.py",
        "torch_sharded_train.py", "torch_shortest_path_pruning.py"]
    assert [f.name for f in files if IMPORT.search(f.read_text())] == []
    env = dict(os.environ, PYTHONPATH=str(SRC))
    r = subprocess.run([sys.executable, "-c", EXAMPLE_PROBE,
                        *map(str, files)], env=env, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    assert r.stdout.split() == ["8"]
