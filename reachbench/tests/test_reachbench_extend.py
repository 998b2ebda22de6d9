"""A configuration, a traffic mix and a per-layer metric are added as new
files and new entries, with no edit to a file that exists: the harness
finds each by its name and runs the new cell."""
import json
import shutil

from reachbench import harness, manifest
from reachbench.tests import tiny


def test_new_config_mix_and_metric_are_found_by_name(tmp_path):
    src = manifest.Manifest()
    home = tmp_path / "reachbench"
    shutil.copytree(src.home, home, ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    before = {p.relative_to(home): p.read_bytes()
              for p in home.rglob("*") if p.is_file()}
    data = json.loads(src.path.read_text())
    cfg, _ = tiny.cell_files(src, "web.bulk")
    cfg.update(name="tiny-web", graph={
        "generator": "scale_free_digraph", "n": tiny.N, "avg_deg": 4.0,
        "back_p": 0.0})
    (home / "configs" / "tiny-web.json").write_text(json.dumps(cfg))
    (home / "traffic" / "bulk_walks.json").write_text(json.dumps({
        "loop": "closed", "pairs_per_call": 2048, "pool_calls": 2,
        "block": 64, "kinds": [["walk", 3], ["random", 1]],
        "max_walk": 8, "warmup_pairs": 2048, "sample_blocks": 8}))
    (home / "metrics" / "session.batches.bulk.py").write_text(
        "def read(ctx):\n    return ctx['session']['n_batches']\n")
    data["configs"].append({
        "name": "tiny-web", "source": "https://example.org/tiny",
        "file": "reachbench/configs/tiny-web.json", "reduced": [],
        "why": "a test's graph"})
    data["workloads"].append({
        "name": "tiny.walks", "config": "tiny-web", "traffic": "bulk_walks",
        "chips": 1, "why": "a test's cell"})
    data["end_to_end"][0]["workloads"].append("tiny.walks")
    data["per_layer"].append({
        "name": "session.batches.bulk", "unit": "batches", "better": "lower",
        "source": "program_counter", "layer": "facade (reach/session.py)",
        "moves": "queries_per_s", "workloads": ["tiny.walks"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(data))
    m = manifest.Manifest(tmp_path / "BENCHMARK.json")
    for trace in (False, True):
        out = harness.run_cell(m, "tiny.walks", 3, 1.0, trace, "cpu", 0.0)
        assert out["correct"] is True
        if trace:
            assert out["metrics"]["session.batches.bulk"]["value"] > 0
        else:
            assert set(out["metrics"]) == {"queries_per_s", "setup_s"}
    after = {p.relative_to(home): p.read_bytes()
             for p in home.rglob("*") if p.is_file()
             and "__pycache__" not in p.parts}
    assert all(after[k] == v for k, v in before.items())
