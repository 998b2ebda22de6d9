"""``BENCHMARK.json`` and the files it names.

Everything particular to one configuration, traffic mix or metric is a file
of its own, found by its name: ``configs/<file>`` as the configuration's
``file`` entry says, ``traffic/<mix>.json``, ``metrics/<metric>.py``. Adding
one is adding its file and its entry; no other file changes.
"""
from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


class Manifest:
    def __init__(self, path: Path = ROOT / "BENCHMARK.json"):
        self.path = Path(path)
        self.root = self.path.parent
        self.data = json.loads(self.path.read_text())
        self.configs = {c["name"]: c for c in self.data["configs"]}
        self.cells = {w["name"]: w for w in self.data["workloads"]}
        self.home = self.root / HERE.name      # this folder, beside the file

    def cell(self, name: str) -> dict:
        if name not in self.cells:
            raise KeyError(f"no workload {name!r} in {self.path}: "
                           f"{sorted(self.cells)}")
        return self.cells[name]

    def config(self, cell: dict) -> dict:
        entry = self.configs[cell["config"]]
        return json.loads((self.root / entry["file"]).read_text())

    def traffic(self, cell: dict) -> dict:
        return json.loads(
            (self.home / "traffic" / f"{cell['traffic']}.json").read_text())

    def metrics(self, cell: dict, trace: bool) -> list:
        """The metric entries a run of ``cell`` reports: its end-to-end
        ones, or with ``trace`` its per-layer ones."""
        name = cell["name"]
        e2e = {m["name"]: m for m in self.data["end_to_end"]}

        def cells_of(m):
            if "workloads" in m:
                return m["workloads"]
            if "moves" in m:             # a per-layer metric without the key
                return cells_of(e2e[m["moves"]])
            return [name]
        group = self.data["per_layer" if trace else "end_to_end"]
        return [m for m in group if name in cells_of(m)]

    def reader(self, name: str):
        """The ``read(ctx)`` function of ``metrics/<name>.py``."""
        path = self.home / "metrics" / f"{name}.py"
        spec = importlib.util.spec_from_file_location(
            "reachbench_metric_" + re.sub(r"\W", "_", name), path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return module.read
