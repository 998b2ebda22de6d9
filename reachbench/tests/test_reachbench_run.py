"""Whole runs of both cells at a CPU test's size: the check holds, and the
result line carries every key a result must have."""
import json

import pytest

from reachbench import harness
from reachbench.tests import tiny


@pytest.mark.parametrize("name", ["web.online", "web.bulk"])
@pytest.mark.parametrize("trace", [False, True])
def test_a_sound_run_is_correct(name, trace):
    out = tiny.run(name, trace=trace)
    assert out["correct"] is True
    assert out["compared"]["mismatches"]["value"] == 0
    assert out["compared"]["unanswered"]["value"] == 0
    assert out["_checked"]["answers"] > 0 and out["_checked"]["positive"] > 0
    assert out["failed"] == 0 and out["attempted"] > 0
    assert list(out)[-3:] == ["compared", "_checked", "_host"]
    m = out["metrics"]
    if trace:
        assert "build.index_s" in m and "busy_s" in out["device"]
        assert "setup_s" not in m
    else:
        assert m["setup_s"]["value"] > 0
        e2e = "requests_on_time_pct" if name == "web.online" else "queries_per_s"
        assert m[e2e]["value"] > 0 and set(m) == {"setup_s", e2e}
    json.dumps(out)


def test_p99_counts_a_lost_request_as_the_slowest():
    assert harness.p99([0.1] * 99 + [float("inf")]) == 0.1
    assert harness.p99([0.1] * 98 + [float("inf")] * 2) == float("inf")
    assert harness.p99([3.0, 1.0, 2.0]) == 3.0


def test_no_card_means_no_result(monkeypatch, capsys):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = harness.main(["--workload", "web.bulk", "--seed", "1",
                       "--seconds", "1", "--trace", "0"], 0.0)
    out = capsys.readouterr()
    assert rc != 0 and out.out == ""
