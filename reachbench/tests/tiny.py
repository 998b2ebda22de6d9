"""The benchmark's cells cut to a size a CPU test run holds: the same
harness, traffic kinds and check, on graphs of 3,000 nodes (above the
dense limit set here, so phase 2 takes the sparse path as on the card) and
windows of a second."""
import copy
import time

from reachbench import harness, manifest

N = 3_000


def cell_files(m, name: str):
    cell = m.cell(name)
    cfg = copy.deepcopy(m.config(cell))
    mix = copy.deepcopy(m.traffic(cell))
    cfg["graph"]["n"] = N
    cfg["index"]["max_batch"] = 1024
    cfg["index"]["n_dense_max"] = 1024
    if mix["loop"] == "open":
        mix["rate_per_s"] = 100
        mix["warmup_pairs"] = 1024
        mix["sample_blocks"] = 8
    else:
        mix["pairs_per_call"] = 4096
        mix["pool_calls"] = 2
        mix["warmup_pairs"] = 4096
        mix["sample_blocks"] = 32
    return cfg, mix


def run(name: str, seed: int = 5, seconds: float = 1.0, trace: bool = False,
        m=None, device: str = "cpu"):
    m = m or manifest.Manifest()
    cfg, mix = cell_files(m, name)
    return harness.run_cell(m, name, seed, seconds, trace, device,
                            time.perf_counter(), cfg=cfg, mix=mix)
