"""The port's examples and the serve CLI's live-update flags on the CPU.

``examples/torch_{quickstart,reachability_serve,shortest_path_pruning,
lm_train,gnn_train}.py`` run end to end with ``--device cpu`` at a small
size (each in its own process, as a user runs them; the LM example
through its injected failure and recovery), and
``examples/torch_moe_expert_parallel.py`` on its four gloo ranks, and
``examples/torch_sharded_train.py`` on two (the Trainer on a 1x2 mesh,
worker 1 failing at step 3, rank 0 re-meshed to one device). The CLI's ``--updates`` / ``--update-batch``
churn loop gives the reference CLI's answers, phase mix and overlay
counters on the same graph and seed (the reference on its XLA loop, whose
overflow rule differs from the fused rule the port keeps, so
``sparse_retries`` may differ), and ``IndexSpec.to_cli_args`` parses back
to the spec, as the reference's argv does.
"""
import argparse
import os
import subprocess
import sys
from dataclasses import asdict
from pathlib import Path

import pytest

from repro.launch import serve as ref_serve
from repro.reach import IndexSpec as RefSpec
from repro_torch.launch import serve
from repro_torch.reach import IndexSpec

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = ROOT / "examples"


def _run(name, *argv):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, str(EXAMPLES / name), *argv],
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    return r.stdout


def test_quickstart_example():
    out = _run("torch_quickstart.py", "--device", "cpu", "--nodes", "3000",
               "--queries", "2000")
    assert "a ~> e ? True" in out and "on cpu" in out
    assert "phase stats: SessionStats(n_queries=4000" in out


def test_reachability_serve_example():
    out = _run("torch_reachability_serve.py", "--device", "cpu", "--nodes",
               "3000", "--queries", "4000")
    assert out.count("phase-2 engine:") == 2
    assert "800 positive queries" in out and "800 positive," in out


def test_shortest_path_pruning_example():
    out = _run("torch_shortest_path_pruning.py", "--device", "cpu",
               "--nodes", "2000", "--pairs", "4")
    assert "identical distances" in out and "on cpu" in out


def test_lm_train_example_recovers_from_its_injected_failure():
    out = _run("torch_lm_train.py", "--device", "cpu", "--steps", "8",
               "--fail-at", "5", "--ckpt-every", "2", "--batch", "4",
               "--seq", "32")
    assert "[FT] worker 0 failed: injected at step 5" in out
    assert "trained 8 steps on cpu with 1 recovery(ies)" in out


def test_gnn_train_example():
    out = _run("torch_gnn_train.py", "--device", "cpu", "--steps", "21",
               "--pairs", "2000")
    assert "verified unreachable by FERRARI (k=2) on cpu" in out
    losses = [float(line.split()[-1]) for line in out.splitlines()
              if line.startswith("step ")]
    assert len(losses) == 2 and losses[1] < losses[0]


def test_moe_expert_parallel_example():
    """The gather and the expert-parallel dispatch train the same losses
    on a 2x2 mesh, attention over 'model' in both; only the
    expert-parallel one sums combines (one a layer and microbatch) and
    copies the activations' gradients over the model group, and the
    gather one gathers the four stored expert leaves whole (their
    gradients whole on every model rank, only cut) where the
    expert-parallel one gathers the router alone (its gradient summed
    over the model group)."""
    out = _run("torch_moe_expert_parallel.py", "--steps", "4")
    rows = [line.split() for line in out.splitlines()
            if line.strip()[:1].isdigit()]
    assert [int(r[0]) for r in rows] == [0, 1, 2, 3]
    for _, gather, ep in rows:
        assert abs(float(gather) - float(ep)) <= 1e-5 * abs(float(gather))
    assert "max loss drift:" in out
    common = ("'grad_norm': 1, 'grad_sum': 13, 'loss': 1, 'loss_max': 4, "
              "'loss_sum': 4, ")
    assert ("gather:          {'copy_to_group': 12, 'gather_from_group': 32, "
            + common + "'sum_over_group': 12, 'zero1_gather': 13}") in out
    assert ("expert-parallel: {'copy_to_group': 20, 'gather_from_group': 16, "
            + common + "'sum_over_group': 20, 'zero1_gather': 13}") in out


def test_sharded_train_example_remeshes_after_its_injected_failure():
    """Two gloo ranks on a 1x2 mesh: worker 1 (rank 1) fails at step 3,
    rank 1 leaves, rank 0 re-meshes to one device, restores step 2 and
    finishes 6 steps; the loss it re-runs step 2 with is the one the
    mesh trained it with, to the printed digits."""
    out = _run("torch_sharded_train.py", "--nproc", "2", "--model", "2",
               "--steps", "6", "--fail-at", "3")
    assert "on 2 ranks, mesh {'data': 1, 'model': 2}" in out
    assert "[FT] worker 1 failed: injected at step 3" in out
    assert "[FT] re-meshed (gen 1) over 1 ranks: one device" in out
    assert "rank 1 left at step 3 (worker 1's)" in out
    assert ("trained 6 steps with 1 recovery(ies), mesh generation 1, "
            "ending on one device") in out
    losses = [line.split()[3] for line in out.splitlines()
              if line.startswith("step ")]
    assert len(losses) == 7 and losses[2] == losses[3]


def test_sharded_cells_example():
    """On two gloo ranks: the tensor-parallel prefill and the decode over
    the cache's split sequence give one device's greedy tokens, the
    partial softmaxes combined over the pair each layer and step; the
    gin-tu step on 2x1 gives one device's loss and grad_norm to the
    printed digits, its segment sums reduced over the data ranks."""
    out = _run("torch_sharded_cells.py", "--steps", "6")
    lines = out.splitlines()
    mesh = next(x for x in lines if "greedy tokens on the mesh" in x)
    one = next(x for x in lines if "greedy tokens, one device" in x)
    assert mesh.split(":")[1] == one.split(":")[1]
    assert "'decode_max': 12, 'decode_sum': 12" in out    # 2 layers x 6
    gnn = next(x for x in lines if x.startswith("gin-tu"))
    got, want = gnn.split(";")
    assert got.split("loss")[1].strip() == want.split("loss")[1].strip()
    assert "'segment_sum': 2" in out


ARGV = ["--nodes", "2000", "--queries", "2048", "--k", "1", "--no-seeds",
        "--phase2", "sparse", "--updates", "256", "--update-batch", "64",
        "--max-batch", "1024"]
MIX = ("n_queries", "n_positive", "phase1_pos", "phase1_neg",
       "phase2_queries", "phase2_dense", "phase2_sparse", "phase2_host",
       "n_updates", "n_overlay_hits", "n_compactions", "overlay_edges",
       "n_batches", "n_padded")


def test_serve_updates_matches_reference_cli(capsys):
    got = serve.main(["--device", "cpu", *ARGV])
    out = capsys.readouterr().out
    assert "256 edge inserts in" in out and "churn stats:" in out
    ref = ref_serve.serve_reachability(
        2000, 4.0, 2048, spec=RefSpec(k=1, use_seeds=False,
                                      phase2_mode="sparse", max_batch=1024),
        seed=0, n_updates=256, update_batch=64)
    assert got["positive"] == ref["positive"]
    for name in ("stats", "update_stats"):
        a, b = asdict(got[name]), asdict(ref[name])
        assert {k: a[k] for k in MIX} == {k: b[k] for k in MIX}, name
    assert got["update_stats"].n_updates > 0


def test_serve_updates_log_and_replay(tmp_path, capsys):
    """With --index-dir the inserts are logged; a rerun replays them and
    extends the graph with fresh edges."""
    argv = ["--device", "cpu", *ARGV, "--index-dir", str(tmp_path)]
    first = serve.main(argv)
    second = serve.main(argv)
    out = capsys.readouterr().out
    assert not first["loaded"] and second["loaded"]
    assert f"resumed at epoch 0 with {first['update_stats'].overlay_edges}" \
        in out
    assert (second["update_stats"].overlay_edges
            > first["update_stats"].overlay_edges)


@pytest.mark.parametrize("kw", [
    {}, dict(k=None, variant="full", use_seeds=False),
    dict(k=5, variant="L", c=2, cover_method="dp", n_seeds=64,
         phase2_mode="sparse", ell_width=16, use_pallas=False,
         kernel_impl="xla", max_batch=4096, min_bucket=64, m_cap=40,
         precondensed=True, auto_compact=False, compact_mode="full"),
    dict(builder="wavefront", cover_method="topgap", merge_chunk=8),
    dict(placement="sharded", mesh="2x4", phase2_mode="sparse",
         deadline_us=900, tenant_queue_cap=64, cache_entries=0,
         latency_window=128),
])
def test_to_cli_args_round_trips(kw):
    spec = IndexSpec(**kw)
    argv = spec.to_cli_args()
    assert argv == RefSpec(**kw).to_cli_args()
    ap = argparse.ArgumentParser()
    IndexSpec.add_cli_args(ap)
    assert IndexSpec.from_args(ap.parse_args(argv)) == spec
