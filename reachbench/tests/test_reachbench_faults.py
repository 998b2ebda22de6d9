"""The check fails a broken program: each fault the cells can have, planted
underneath a whole run at a CPU test's size, and the control (the reference
cut at a few hops, in the program's place) all come out not correct."""
import numpy as np
import pytest
import torch

from reachbench import control, reference
from reachbench.tests import tiny
from repro_torch.core.query_torch import DeviceQueryEngine

CELLS = ["web.online", "web.bulk"]


def _flip_every_16th(engine, handle, ans):
    ans[::16] = ~ans[::16]
    return ans


def _half_left_out(engine, handle, ans):
    # the batch's own pairs, not the (0, 0) rows that pad it to its bucket
    _, cs, ct, _ = handle
    real = np.flatnonzero((cs != 0) | (ct != 0)).max(initial=-1) + 1
    ans[real // 2:real] = False
    return ans


def _control_in_place(engine, handle, ans):
    _, cs, ct, _ = handle
    src, dst = engine.index.cond.dag.edges()
    return reference.control_answers(engine.packed.n, src, dst, cs.cpu(),
                                     ct.cpu(), control.HOPS)


FAULTS = {"answer_altered": _flip_every_16th,
          "half_the_batch_left_out": _half_left_out,
          "control": _control_in_place}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("name", CELLS)
def test_a_broken_program_is_not_correct(monkeypatch, name, fault):
    plant = FAULTS[fault]
    finish = DeviceQueryEngine.finish_answer

    def broken(self, handle):
        return plant(self, handle, finish(self, handle))
    monkeypatch.setattr(DeviceQueryEngine, "finish_answer", broken)
    out = tiny.run(name, seed=9)
    assert out["correct"] is False
    assert out["compared"]["mismatches"]["value"] > 0


@pytest.mark.parametrize("name", CELLS)
def test_the_control_alone_reads_mismatches(name):
    from reachbench import manifest
    m = manifest.Manifest()
    cfg, mix = tiny.cell_files(m, name)
    r = control.readings(m, name, 4, 1.0, control.HOPS, "cpu", cfg, mix)
    assert r["mismatches"] > 0 and r["reachable"] > 0


@pytest.mark.cuda
def test_the_cells_on_the_card_at_a_tests_size():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's kernels run only there")
    for name in CELLS:
        out = tiny.run(name, device="cuda:0")
        assert out["correct"] is True, out["compared"]
        assert np.isfinite(out["device"]["memory_peak_bytes"])
