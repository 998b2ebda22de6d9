"""Elastic re-meshing in the port (``runtime.elastic``, the Trainer's
``mesh`` and ``elastic`` arguments) on four gloo ranks on the CPU: the
cases of ``tests/test_elastic.py`` and ``tests/test_elastic_trainer.py``.

The ranks are subprocesses of one process group (a FileStore under the
test's temporary directory, no network). ``ElasticMeshManager
(prefer_model=2)`` lays the four out 2x2; excluding rank 1 leaves three,
of which the largest power of two, ranks 0 and 2, form a 1x2 mesh, and
``reshard`` moves a leaf from the 2x2 blocks to the 1x2 ones with its
values unchanged. The Trainer on the 2x2 mesh (tinyllama-1.1b's SMOKE
config, batch 8 × 32) recovers from an injected failure at step 7 on
the same mesh and completes 12 steps. With the manager, a failure of
worker 1 of 2 (ranks 2 and 3) at step 6 re-meshes to 1x2 over ranks 0
and 1 (``generation`` 1): ranks 2 and 3 return from ``run``, ranks 0 and
1 restore the step-6 checkpoint written at 2x2, each its blocks, and
finish 10 steps; their losses after the recovery and their state equal,
bit for bit, those of a Trainer on that 1x2 mesh resumed from the same
checkpoint.
"""
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

pytestmark = pytest.mark.arch

SRC = Path(__file__).resolve().parents[1] / "src"
TIMEOUT = 300
WORLD = 4

RANK = r"""
import json, shutil, sys
from pathlib import Path
import numpy as np
import torch
import torch.distributed as dist
torch.set_num_threads(1)
cfg = json.loads(sys.argv[1])
rank = int(sys.argv[2])
dist.init_process_group("gloo", rank=rank, world_size=cfg["world"],
                        store=dist.FileStore(cfg["store"], cfg["world"]))
from repro_torch.checkpoint.checkpoint import _flatten_with_paths
from repro_torch.launch.mesh import Mesh, make_debug_mesh
from repro_torch.launch.train import Trainer
from repro_torch.parallel.sharding import local_slice, named_sharding
from repro_torch.runtime.elastic import ElasticMeshManager, reshard
from repro_torch.runtime.fault_tolerance import (FaultInjector,
                                                 HeartbeatMonitor)
out = {}
tmp = Path(cfg["tmp"])

# re-mesh and reshard
mgr = ElasticMeshManager(prefer_model=2, device="cpu")
mesh0 = mgr.current_mesh()
w = torch.from_numpy(np.random.default_rng(0).standard_normal(
    (16, 8)).astype(np.float32))
sh0 = named_sharding(("batch", "mlp"), w.shape, mesh0)
w0 = local_slice(w, sh0.spec, mesh0).clone()
mgr.exclude([1])
mesh1 = mgr.current_mesh()
sh1 = named_sharding(("batch", "mlp"), w.shape, mesh1)
w1 = reshard({"w": w0}, {"w": sh1}, {"w": sh0})["w"]
out["remesh"] = dict(
    sizes0=mesh0.sizes, sizes1=mesh1.sizes, ranks1=list(mesh1.ranks),
    member1=mesh1.member, generation=mgr.generation, alive=mgr.alive,
    workers=[mgr.devices_of_worker(i, 2) for i in range(2)],
    spec0=list(sh0.spec), spec1=list(sh1.spec),
    block_ok=(w1 is None if not mesh1.member else
              bool(torch.equal(w1, local_slice(w, sh1.spec, mesh1)))),
    block_shape=None if w1 is None else list(w1.shape))

def trainer(**kw):
    return Trainer("tinyllama-1.1b", smoke=True, device="cpu",
                   batch_override=8, seq_override=32, **kw)

# recovery on the same mesh
tr = trainer(ckpt_dir=str(tmp / "ckpt_ft"),
             mesh=make_debug_mesh(model=2, device="cpu"),
             fault_injector=FaultInjector.worker_failure_at(7))
tr.restore_or_init()
hist = tr.run(12, ckpt_every=5, log_every=100)
out["ft"] = dict(recoveries=tr.recoveries, step=tr.step_idx,
                 losses=[h["loss"] for h in hist],
                 mesh=dict(tr.mesh.sizes))

# elastic: worker 1 of 2 (ranks 2, 3) fails at step 6
mgr = ElasticMeshManager(prefer_model=2, device="cpu")
tr = trainer(ckpt_dir=str(tmp / "ckpt_el"), mesh=mgr.current_mesh(),
             fault_injector=FaultInjector.worker_failure_at(6, worker=1),
             elastic=mgr)
tr.monitor = HeartbeatMonitor(n_workers=2, timeout_s=3600)
out["el_start"] = dict(tr.mesh.sizes)
tr.restore_or_init()
hist = tr.run(10, ckpt_every=3, log_every=100)
out["el"] = dict(recoveries=tr.recoveries, step=tr.step_idx, left=tr.left,
                 generation=mgr.generation,
                 mesh=None if tr.mesh is None else dict(tr.mesh.sizes),
                 losses=[h["loss"] for h in hist])
dist.barrier()
if rank == 0:                 # the step-6 checkpoint, written at 2x2
    for name in ("step_6", "step_6.done"):
        src = tmp / "ckpt_el" / name
        (shutil.copytree if src.is_dir() else shutil.copy)(
            src, tmp / "ckpt_resume" / name)
dist.barrier()
# the same 1x2 mesh, resumed from that checkpoint
mesh = Mesh((1, 2), ("data", "model"), ranks=[0, 1], device="cpu")
if mesh.member:
    again = trainer(ckpt_dir=str(tmp / "ckpt_resume"), mesh=mesh)
    assert again.restore_or_init()
    out["resumed_from"] = again.step_idx
    h2 = again.run(10, ckpt_every=100, log_every=100)
    out["resumed_losses"] = [h["loss"] for h in h2]
    out["same_state"] = all(
        torch.equal(a, b) for (_, a), (_, b) in zip(
            _flatten_with_paths(tr.state), _flatten_with_paths(again.state)))
with open(cfg["out"] % rank, "w") as f:
    json.dump(out, f)
dist.barrier()
dist.destroy_process_group()
"""


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("elastic")
    cfg = dict(world=WORLD, store=str(tmp / "store"), tmp=str(tmp),
               out=str(tmp / "rank%d.json"))
    env = {**os.environ, "PYTHONPATH": str(SRC), "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen([sys.executable, "-c", RANK, json.dumps(cfg),
                               str(r)], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(WORLD)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log
    return [json.loads((tmp / f"rank{r}.json").read_text())
            for r in range(WORLD)], logs


def test_remesh_and_reshard_preserves_values(ranks):
    out, _ = ranks
    for r, o in enumerate(out):
        rm = o["remesh"]
        assert rm["sizes0"] == {"data": 2, "model": 2}
        assert rm["sizes1"] == {"data": 1, "model": 2}
        assert rm["ranks1"] == [0, 2] and rm["alive"] == [0, 2, 3]
        assert rm["generation"] == 1
        assert rm["workers"] == [[0, 1], [2, 3]]
        assert rm["spec0"] == ["data", "model"]
        assert rm["member1"] == (r in (0, 2))
        assert rm["block_ok"], r
        assert rm["block_shape"] == ([16, 4] if r in (0, 2) else None)


def test_trainer_recovers_from_injected_failure_on_a_mesh(ranks):
    out, logs = ranks
    for o in out:
        ft = o["ft"]
        assert ft["recoveries"] == 1 and ft["step"] == 12
        assert ft["mesh"] == {"data": 2, "model": 2}
        assert all(math.isfinite(x) for x in ft["losses"])
        assert ft["losses"] == out[0]["ft"]["losses"]
    assert "[FT] worker 0 failed: injected at step 7" in logs[0]


def test_trainer_remeshes_on_worker_failure(ranks):
    out, logs = ranks
    for r, o in enumerate(out):
        el = o["el"]
        assert o["el_start"] == {"data": 2, "model": 2}
        assert el["recoveries"] == 1 and el["generation"] == 1
        assert all(math.isfinite(x) for x in el["losses"])
        if r < 2:
            assert not el["left"] and el["step"] == 10
            assert el["mesh"] == {"data": 1, "model": 2}
            assert len(el["losses"]) == 10
        else:                       # worker 1's ranks leave at step 6
            assert el["left"] and el["step"] == 6
            assert len(el["losses"]) == 6
    assert "[FT] re-meshed (gen 1) over 2 ranks" in logs[0]


def test_survivors_equal_a_run_resumed_on_their_mesh(ranks):
    """After the re-mesh the survivors resume from the step-6 checkpoint
    written at 2x2: their losses and state equal a fresh 1x2 Trainer's
    resumed from it, bit for bit."""
    out, _ = ranks
    for o in out[:2]:
        assert o["resumed_from"] == 6
        assert o["el"]["losses"][6:] == o["resumed_losses"]
        assert o["same_state"]
    assert out[0]["el"]["losses"] == out[1]["el"]["losses"]
    assert np.isfinite(out[0]["resumed_losses"]).all()
