"""The GPipe forward (``parallel.pipeline``) and gradient compression
(``optim.compression``) of the port against the reference's.

``pipeline_forward`` runs on four gloo ranks (a FileStore under the
test's temporary directory, no network) over a ('pod',) mesh of four
stages with 4 microbatches, and ``compressed_psum`` over a ('data',)
mesh of four; the reference runs both in a subprocess that sets
``--xla_force_host_platform_device_count=4`` before JAX loads, on the
same inputs (its own test's: D 8, B 16, 4 stages; x [4, 64]). The
pipeline's output on every rank matches the sequential forward and the
reference's within the reference test's 2e-4; the compressed sum is
within 4 × scale of the exact one, as the reference test holds it, and
equals the reference's bit for bit on every rank. ``quantize_int8`` and
``compress_with_feedback`` equal the reference's bit for bit on the
cases of ``tests/test_substrates.py`` (100 steps of error feedback) and
on values at the rounding ties.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import compression as ref_comp
from repro_torch.optim import compression as comp
from repro_torch.parallel.pipeline import demo_stage_fn

SRC = Path(__file__).resolve().parents[1] / "src"
TIMEOUT = 240
WORLD = 4
D, B, S, MB = 8, 16, 4, 4

REF = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import json
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import PartitionSpec as P
from repro.launch.mesh import make_mesh_compat
from repro.optim.compression import compressed_psum
from repro.parallel.pipeline import demo_stage_fn, pipeline_forward
from repro.parallel.sharding import shard_map_compat
cfg = json.loads(sys.argv[1])
data = dict(np.load(cfg["data"]))
mesh = make_mesh_compat((4,), ("pod",))
pipe = pipeline_forward(mesh, demo_stage_fn, n_stages=4, microbatches=4)
out = {"pipe": np.asarray(jax.jit(pipe)(
    {"w": jnp.asarray(data["w"]), "w2": jnp.asarray(data["w2"])},
    jnp.asarray(data["x"])))}
mesh = make_mesh_compat((4,), ("data",))
f = shard_map_compat(lambda v: compressed_psum(v[0], "data"), mesh=mesh,
                     in_specs=P("data", None), out_specs=P(None))
out["psum"] = np.asarray(jax.jit(f)(jnp.asarray(data["shards"])))
np.savez(cfg["out"], **out)
"""

RANK = r"""
import json, sys
import numpy as np
import torch
import torch.distributed as dist
torch.set_num_threads(1)
cfg = json.loads(sys.argv[1])
rank = int(sys.argv[2])
dist.init_process_group("gloo", rank=rank, world_size=cfg["world"],
                        store=dist.FileStore(cfg["store"], cfg["world"]))
from repro_torch.launch.mesh import Mesh
from repro_torch.optim.compression import compressed_psum
from repro_torch.parallel import CALLS
from repro_torch.parallel.pipeline import demo_stage_fn, pipeline_forward
data = {k: torch.from_numpy(v) for k, v in np.load(cfg["data"]).items()}
mesh = Mesh((4,), ("pod",), device="cpu")
i = mesh.index("pod")
pipe = pipeline_forward(mesh, demo_stage_fn, n_stages=4, microbatches=4)
out = {"pipe": pipe({"w": data["w"][i:i + 1], "w2": data["w2"][i:i + 1]},
                    data["x"]).numpy()}
out["pipe_calls"] = np.array(json.dumps(dict(CALLS)))
mesh = Mesh((4,), ("data",), device="cpu")
out["psum"] = compressed_psum(data["shards"][mesh.index("data")],
                              mesh.group("data")).numpy()
np.savez(cfg["out"] % rank, **out)
dist.destroy_process_group()
"""


def _run(script, argv_cfg, n_procs=1):
    env = {**os.environ, "PYTHONPATH": str(SRC), "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen([sys.executable, "-c", script,
                               json.dumps(argv_cfg), str(r)], env=env,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(n_procs)]
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


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("parallel")
    rng = np.random.default_rng(0)
    data = {"w": rng.standard_normal((S, D, D)).astype(np.float32),
            "w2": rng.standard_normal((S, D, D)).astype(np.float32),
            "x": rng.standard_normal((B, D)).astype(np.float32),
            "shards": rng.standard_normal((WORLD, 64)).astype(np.float32)}
    np.savez(tmp / "data.npz", **data)
    _run(REF, dict(data=str(tmp / "data.npz"), out=str(tmp / "ref.npz")))
    _run(RANK, dict(data=str(tmp / "data.npz"), world=WORLD,
                    store=str(tmp / "store"), out=str(tmp / "rank%d.npz")),
         WORLD)
    return (data, dict(np.load(tmp / "ref.npz")),
            [dict(np.load(tmp / f"rank{r}.npz")) for r in range(WORLD)])


def test_pipeline_matches_sequential_and_reference(world):
    data, ref, ranks = world
    want = torch.from_numpy(data["x"])
    for i in range(S):
        want = demo_stage_fn({"w": torch.from_numpy(data["w"][i]),
                              "w2": torch.from_numpy(data["w2"][i])}, want)
    for r in ranks:
        np.testing.assert_allclose(r["pipe"], want.numpy(), rtol=2e-4,
                                   atol=2e-4)
        np.testing.assert_allclose(r["pipe"], ref["pipe"], rtol=2e-4,
                                   atol=2e-4)
    # stage 0 sends each microbatch on; the last stage only receives
    calls = [json.loads(str(r["pipe_calls"])) for r in ranks]
    assert calls[0] == {"pipeline_send": MB, "pipeline_broadcast": 1}
    assert calls[-1] == {"pipeline_recv": MB, "pipeline_broadcast": 1}


def test_compressed_psum_close_to_exact_and_the_reference(world):
    data, ref, ranks = world
    exact = data["shards"].sum(0)
    scale = np.abs(data["shards"]).max() / 127.0
    for r in ranks:
        assert np.abs(r["psum"] - exact).max() <= 4 * scale + 1e-6
        np.testing.assert_array_equal(r["psum"], ref["psum"])


CASES = [np.random.default_rng(0).standard_normal(1000).astype(np.float32),
         np.array([1e-4, 2e-4, 0.5], np.float32),
         # values landing on the rounding ties (x / scale = k + 0.5)
         (np.arange(-8, 9, dtype=np.float32) + 0.5) / 127.0 * 8.5,
         np.zeros(5, np.float32),
         np.random.default_rng(1).standard_normal((7, 33)).astype(
             np.float32) * 1e3]


@pytest.mark.parametrize("x", CASES, ids=["normal", "tiny", "ties", "zero",
                                          "large"])
def test_quantize_int8_bit_for_bit(x):
    q, s = comp.quantize_int8(torch.from_numpy(x))
    rq, rs = ref_comp.quantize_int8(jnp.asarray(x))
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(rs))
    np.testing.assert_array_equal(comp.dequantize_int8(q, s).numpy(),
                                  np.asarray(ref_comp.dequantize_int8(rq,
                                                                      rs)))
    err = np.abs(x - q.numpy().astype(np.float32) * float(s))
    assert err.max() <= float(s) * 0.5 + 1e-6


def test_error_feedback_bit_for_bit():
    """The reference test's case: tiny gradients that int8 rounds away get
    through over 100 steps, every step's dequantized gradient and error
    the reference's."""
    g = {"w": np.array([1e-4, 2e-4, 0.5], np.float32),
         "b": [np.array([3e-3, -7e-5], np.float32)]}
    grads = {"w": torch.from_numpy(g["w"]),
             "b": [torch.from_numpy(g["b"][0])]}
    rgrads = {"w": jnp.asarray(g["w"]), "b": [jnp.asarray(g["b"][0])]}
    e, re = comp.init_error_state(grads), ref_comp.init_error_state(rgrads)
    total = np.zeros(3, np.float32)
    for _ in range(100):
        (d, e), (rd, re) = (comp.compress_with_feedback(grads, e),
                            ref_comp.compress_with_feedback(rgrads, re))
        for got, want in ((d["w"], rd["w"]), (d["b"][0], rd["b"][0]),
                          (e["w"], re["w"]), (e["b"][0], re["b"][0])):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        total += d["w"].numpy()
    np.testing.assert_allclose(total / 100, g["w"], rtol=0.1, atol=1e-5)
