"""A run loads neither JAX nor the JAX package, and the reference loads
nothing of the port: looked up in fresh processes, by whole top-level
module names."""
import json
import subprocess
import sys

from reachbench.tests.conftest import ROOT

LOOK = ("import json, sys\n"
        "print(json.dumps(sorted({n.split('.')[0] for n in sys.modules})))\n")


def _modules(code: str) -> set:
    run = subprocess.run(
        [sys.executable, "-c", f"import sys\nsys.path[:0] = "
         f"[{str(ROOT)!r}, {str(ROOT / 'src')!r}]\n" + code + LOOK],
        capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert run.returncode == 0, run.stderr[-2000:]
    return set(json.loads(run.stdout.splitlines()[-1]))


def test_a_run_loads_no_jax():
    found = _modules(
        "import torch\ntorch.set_num_threads(1)\n"
        "from reachbench.tests import tiny\n"
        "out = tiny.run('web.online', seconds=0.5)\n"
        "assert out['correct']\n"
        "out = tiny.run('web.bulk', seconds=0.5)\n"
        "assert out['correct']\n")
    assert "repro_torch" in found
    assert not found & {"jax", "jaxlib", "flax", "repro", "benchmarks"}


def test_the_reference_loads_nothing_of_the_port():
    found = _modules("import reachbench.reference, reachbench.gen\n")
    assert not found & {"jax", "jaxlib", "flax", "repro", "repro_torch",
                        "benchmarks"}
