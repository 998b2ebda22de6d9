"""The port's fault-tolerant training on the CPU: the fault-tolerance
classes (as ``tests/test_substrates.py`` holds the reference's), the
``CheckpointManager`` (retention, writes after ``save`` returns, the last
committed step), checkpoints crossing between the packages in both
directions, and the ``Trainer`` recovering from injected failures to the
bits of an uninterrupted run.

Tolerances: bit for bit within the port (the CPU is deterministic);
rtol 1e-4 for a loss the two packages compute from one checkpoint.
"""
import json

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpoint as ref_ckpt
from repro.launch.train import Trainer as RefTrainer
from repro_torch.checkpoint import (CheckpointManager, latest_step,
                                    restore_like, save_checkpoint)
from repro_torch.checkpoint.checkpoint import _flatten_with_paths
from repro_torch.launch import train
from repro_torch.launch.train import Trainer
from repro_torch.runtime.fault_tolerance import (FaultInjector,
                                                 HeartbeatMonitor, Preemption,
                                                 SpeculativeFetcher,
                                                 StragglerDetector,
                                                 WorkerFailure)

ARCH = "tinyllama-1.1b"
SMALL = dict(batch_override=4, seq_override=32)


def _leaves(tree):
    return [leaf for _, leaf in _flatten_with_paths(tree)]


def _bits_equal(a, b):
    la, lb = _flatten_with_paths(a), _flatten_with_paths(b)
    assert [p for p, _ in la] == [p for p, _ in lb]
    return all(x.dtype == y.dtype and torch.equal(x, y)
               for (_, x), (_, y) in zip(la, lb))


# --------------------------------------------------------- fault tolerance --
def test_straggler_detector():
    d = StragglerDetector(factor=3.0, min_samples=3)
    for _ in range(5):
        assert not d.observe(0, 1.0)
    assert d.observe(5, 10.0)          # 10x slower -> flagged
    assert not d.observe(6, 1.0)       # ewma not poisoned
    assert d.flagged == [5] and d.ewma == pytest.approx(1.0)


def test_heartbeat_monitor():
    m = HeartbeatMonitor(n_workers=2, timeout_s=10.0)
    m.beat(0, t=0.0)
    m.beat(1, t=0.0)
    m.check(t=5.0)
    m.beat(0, t=9.0)
    with pytest.raises(WorkerFailure):
        m.check(t=11.0)
    assert m.alive_workers() == [0]
    m.check(t=12.0)                    # a dead worker is not checked again


def test_fault_injector_fires_once():
    inj = FaultInjector.worker_failure_at(step=3, worker=1)
    inj.maybe_fire(2)
    with pytest.raises(WorkerFailure) as e:
        inj.maybe_fire(3)
    assert e.value.worker == 1
    inj.maybe_fire(3)                  # fired already
    with pytest.raises(Preemption):
        FaultInjector.preemption_at(0).maybe_fire(0)


def test_speculative_fetcher_takes_the_backup_on_timeout():
    def slow(shard):
        raise TimeoutError(shard)

    f = SpeculativeFetcher(slow, backup_loader=lambda s: s * 10)
    with pytest.raises(TimeoutError):
        f.fetch(1)
    f.use_backup = True
    assert f.fetch(2) == 20 and f.backup_wins == 1
    assert SpeculativeFetcher(lambda s: s + 1).fetch(4) == 5


# ------------------------------------------------------------ checkpoints --
def _state(seed=0, n_layers=12):
    g = torch.Generator().manual_seed(seed)
    return {"params": {"layers": [{"w": torch.randn(3, 2, generator=g),
                                   "b": torch.randn(2, generator=g)}
                                  for _ in range(n_layers)],
                       "emb": torch.randn(5, 4, generator=g).to(
                           torch.bfloat16)},
            "opt": {"step": torch.tensor(seed, dtype=torch.int32)}}


def test_leaf_paths_and_order_match_the_reference():
    state = _state()
    ref_paths, *_ = ref_ckpt._flatten_with_paths(
        jax.tree.map(lambda t: np.asarray(t.float()), state))
    assert [p for p, _ in _flatten_with_paths(state)] == ref_paths
    assert ref_paths[:3] == ["opt/step", "params/emb", "params/layers/0/b"]
    assert ref_paths.index("params/layers/2/w") < ref_paths.index(
        "params/layers/10/b")


def test_manager_keeps_the_last_committed_steps(tmp_path):
    mgr = CheckpointManager(tmp_path, keep_last=2)
    for step in (1, 2, 3, 4):
        mgr.save(step, _state(step), extra={"data_state": {"step": step}})
    mgr.wait()
    assert mgr.save_count == 4
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "step_3", "step_3.done", "step_4", "step_4.done"]
    # a torn save (no .done marker) is never picked
    (tmp_path / "step_9").mkdir()
    assert latest_step(tmp_path) == 4
    state, manifest = mgr.restore_latest(_state(0))
    assert manifest["step"] == 4 and manifest["extra"]["data_state"] == {
        "step": 4}
    assert _bits_equal(state, _state(4))
    assert state["params"]["emb"].dtype == torch.bfloat16


def test_manager_copies_the_state_before_it_returns(tmp_path):
    mgr = CheckpointManager(tmp_path)
    state = _state(1)
    mgr.save(1, state)
    for leaf in _leaves(state):        # the next step updates in place
        leaf.add_(1)
    mgr.wait()
    got, _ = mgr.restore_latest(state)
    assert _bits_equal(got, _state(1))


def test_manager_writes_after_save_returns(tmp_path, monkeypatch):
    import threading

    from repro_torch.checkpoint import checkpoint as ckpt
    gate = threading.Event()
    real = ckpt.save_checkpoint

    def held(*a, **kw):
        gate.wait(30)
        return real(*a, **kw)

    monkeypatch.setattr(ckpt, "save_checkpoint", held)
    mgr = CheckpointManager(tmp_path)
    mgr.save(5, _state(5))
    assert latest_step(tmp_path) is None     # still writing
    gate.set()
    mgr.wait()
    assert latest_step(tmp_path) == 5


def test_restore_refuses_another_structure(tmp_path):
    mgr = CheckpointManager(tmp_path, async_save=False)
    assert mgr.restore_latest(_state()) == (None, None)
    mgr.save(1, _state(1))
    with pytest.raises(ValueError, match="structure mismatch"):
        mgr.restore_latest(_state(1, n_layers=3))
    wrong = _state(1)
    wrong["params"]["emb"] = torch.zeros(4, 4, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="shape"):
        mgr.restore_latest(wrong)


def test_restore_places_leaves_on_the_like_dtypes(tmp_path):
    save_checkpoint(tmp_path, 2, {"w": np.arange(6, dtype=np.float64)})
    like = {"w": torch.zeros(6, dtype=torch.float32)}
    got, manifest = restore_like(tmp_path, like)
    assert got["w"].dtype == torch.float32 and manifest["step"] == 2
    assert torch.equal(got["w"], torch.arange(6, dtype=torch.float32))


# ------------------------------------------------ across the two packages --
def test_reference_checkpoint_resumed_by_port_trainer(tmp_path):
    ref = RefTrainer(ARCH, smoke=True, ckpt_dir=str(tmp_path), **SMALL)
    ref.restore_or_init()
    ref.run(4, ckpt_every=2, log_every=100)
    tr = Trainer(ARCH, device="cpu", ckpt_dir=str(tmp_path), **SMALL)
    assert tr.restore_or_init() and tr.step_idx == 4
    hist = tr.run(5, ckpt_every=100, log_every=100)
    want = ref.run(5, ckpt_every=100, log_every=100)
    assert hist[-1]["step"] == want[-1]["step"] == 4
    np.testing.assert_allclose(hist[-1]["loss"], want[-1]["loss"],
                               rtol=1e-4)


def test_port_checkpoint_read_by_reference(tmp_path):
    tr = Trainer(ARCH, device="cpu", ckpt_dir=str(tmp_path), **SMALL)
    tr.restore_or_init()
    tr.run(2, ckpt_every=1, log_every=100)
    ref = RefTrainer(ARCH, smoke=True, **SMALL)
    state, manifest = ref_ckpt.restore_checkpoint(tmp_path,
                                                  ref.cell.state_sds)
    assert manifest["step"] == 2
    assert manifest["extra"]["data_state"]["step"] == 2
    want = dict(_flatten_with_paths(tr.state))
    paths, leaves, _ = ref_ckpt._flatten_with_paths(state)
    assert sorted(paths) == sorted(want)
    for path, leaf in zip(paths, leaves):
        np.testing.assert_array_equal(np.asarray(leaf),
                                      want[path].numpy(), err_msg=path)
    # and the reference's own Trainer resumes from it
    ref = RefTrainer(ARCH, smoke=True, ckpt_dir=str(tmp_path), **SMALL)
    assert ref.restore_or_init() and ref.step_idx == 2


# -------------------------------------------------------------- recovery --
def _trained(tmp_path, injector, steps=6, every=2):
    tr = Trainer(ARCH, device="cpu", ckpt_dir=str(tmp_path),
                 fault_injector=injector, **SMALL)
    tr.restore_or_init()
    hist = tr.run(steps, ckpt_every=every, log_every=100)
    return tr, hist


@pytest.mark.parametrize("injector", [
    lambda: FaultInjector.worker_failure_at(step=5),
    lambda: FaultInjector.preemption_at(3)], ids=["worker", "preemption"])
def test_trainer_recovers_to_the_bits_of_an_uninterrupted_run(tmp_path,
                                                              injector):
    clean, clean_hist = _trained(tmp_path / "a", None)
    tr, hist = _trained(tmp_path / "b", injector())
    assert tr.recoveries == 1 and clean.recoveries == 0
    assert tr.step_idx == clean.step_idx == 6
    assert len(hist) > len(clean_hist)            # steps re-run
    by_step = {h["step"]: h["loss"] for h in hist}
    assert by_step == {h["step"]: h["loss"] for h in clean_hist}
    assert _bits_equal(tr.state, clean.state)
    assert latest_step(tmp_path / "b") == 6


def test_trainer_gives_up_after_max_recoveries(tmp_path):
    inj = FaultInjector(schedule={s: (lambda: WorkerFailure(0))
                                  for s in (1, 2)})
    tr = Trainer(ARCH, device="cpu", ckpt_dir=str(tmp_path),
                 fault_injector=inj, **SMALL)
    tr.restore_or_init()
    with pytest.raises(WorkerFailure):
        tr.run(4, ckpt_every=1, max_recoveries=1, log_every=100)
    assert tr.recoveries == 2


def test_train_cli_resumes_from_its_checkpoints(tmp_path, capsys):
    argv = ["--device", "cpu", "--batch", "4", "--seq", "16",
            "--log-every", "1", "--ckpt-dir", str(tmp_path),
            "--ckpt-every", "1"]
    train.main([*argv, "--steps", "2"])
    hist = train.main([*argv, "--steps", "3"])
    out = capsys.readouterr().out
    assert f"resumed from {tmp_path} at step 2" in out
    assert [h["step"] for h in hist] == [2]
    manifest = json.loads((tmp_path / "step_3" / "manifest.json").read_text())
    assert manifest["extra"]["data_state"]["step"] == 3
