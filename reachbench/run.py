"""Run one cell of BENCHMARK.json once and print its result as one JSON line.

    python3 reachbench/run.py --workload web.online --seed 7 --seconds 30 --trace 0

Runs on the machine it is started on, from the root of a checkout that holds
the port under ``src/repro_torch``; the port's kernels build into
``build/kernels/`` there at first use. Exits non-zero, with no result, when
no CUDA card is present (or fewer than the cell asks for), and when the run
loaded JAX or the JAX package.
"""
import time

CLOCK0 = time.perf_counter()      # set-up is timed from here

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# the checkout's root instead of this script's folder, and the port's source
sys.path[0] = str(ROOT)
sys.path.insert(1, str(ROOT / "src"))
for var, sub in (("TRITON_CACHE_DIR", "triton"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
    os.environ[var] = str(ROOT / "build" / sub)

from reachbench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], CLOCK0))
