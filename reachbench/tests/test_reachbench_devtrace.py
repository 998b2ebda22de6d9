"""The trace arithmetic on a made-up window: busy time is the union of the
device's events inside the window, idle time goes to the spans open
during it."""
import pytest

from reachbench import devtrace

W = devtrace.WINDOW


def test_busy_share_and_gap_labels():
    ms = 1_000_000
    evts = [
        (W, False, 0, 100 * ms),
        ("reachbench.online.poll", False, 0, 50 * ms),
        ("reachbench.online.wait", False, 50 * ms, 100 * ms),
        ("void stab_packed_kernel(int const*)", True, 10 * ms, 20 * ms),
        ("Memcpy HtoD (Pinned -> Device)", True, 15 * ms, 28 * ms),
        ("expand_probe_kernel", True, 60 * ms, 70 * ms),
        ("expand_probe_kernel", True, 95 * ms, 120 * ms),   # cut at 100
        ("expand_probe_kernel", True, -5 * ms, -1 * ms),    # before the window
    ]
    out = devtrace.summarize(evts)
    assert out["window_s"] == pytest.approx(0.1)
    assert out["busy_s"] == pytest.approx(0.033)
    k = out["kernels"]
    assert k["stab_packed_kernel"] == [pytest.approx(0.01), 1]
    assert k["expand_probe_kernel"] == [pytest.approx(0.015), 2]
    gaps = dict(out["breakdown"]["idle_gaps"])
    assert gaps["online.poll"] == pytest.approx(0.032)    # 0-10, 28-50
    assert gaps["online.wait"] == pytest.approx(0.035)    # 50-60, 70-95
    assert "none" not in gaps
    assert out["breakdown"]["device_ops"][0][0] == "expand_probe_kernel"


def test_one_window_span_is_required():
    with pytest.raises(ValueError):
        devtrace.summarize([("x", True, 0, 1)])


@pytest.mark.parametrize("raw, own", [
    ("void (anonymous namespace)::expand_probe_kernel(Step)",
     "expand_probe_kernel"),
    ("void (anonymous namespace)::stab_packed_kernel<4, false>(int const*, "
     "int const*, int*, int)", "stab_packed_kernel"),
    ("stab_packed_one<false>", "stab_packed_one"),
    ("Memcpy HtoD (Pinned -> Device)", "Memcpy HtoD"),
])
def test_kernel_names(raw, own):
    assert devtrace.base_name(devtrace.kernel_name(raw)) == own


def _trace(kernels, busy_s=1.0):
    return {"busy_s": busy_s, "window_s": 2.0, "kernels": kernels}


@pytest.mark.parametrize("kernels, want", [
    ({"(anonymous namespace)::expand_probe_kernel": [0.25, 9],
      "(anonymous namespace)::mark_kernel": [0.5, 4]}, 9),
    ({"expand_probe_kernel": [0.1, 2],
      "(anonymous namespace)::expand_probe_kernel": [0.2, 3]}, 5),
    ({"(anonymous namespace)::expand_probe_rows_kernel": [0.1, 7]}, 0),
    ({}, 0)])
def test_kernel3_events_are_counted_by_the_kernels_own_name(kernels, want):
    assert devtrace.kernel3_traced(_trace(kernels)) == want


def test_request_p99_is_the_tail_of_every_request():
    from reachbench import manifest
    import numpy as np
    read = manifest.Manifest().reader("frontend.request_p99_ms")
    lat = np.r_[np.full(990, 0.01), np.full(10, 2.0)]
    assert read({"host": {"latency_s": lat}}) == pytest.approx(10.0)
    lat[-11] = 2.0
    assert read({"host": {"latency_s": lat}}) == pytest.approx(2000.0)
    assert read({"host": {}}) is None


def test_on_time_share_counts_every_request_and_a_lost_one_as_late():
    from reachbench import manifest
    import numpy as np
    read = manifest.Manifest().reader("requests_on_time_pct")
    lat = np.r_[np.full(990, 0.01), np.full(9, 0.5), np.inf]
    assert read({"host": {"latency_s": lat}, "mix": {"slo_ms": 300}}) \
        == pytest.approx(99.0)
    assert read({"host": {"latency_s": lat}, "mix": {"slo_ms": 500}}) \
        == pytest.approx(99.9)
    assert read({"host": {}, "mix": {"slo_ms": 300}}) is None
    assert read({"host": {"latency_s": lat}, "mix": {}}) is None


def test_kernel1_roofline_from_the_served_calls():
    import numpy as np
    from reachbench import manifest, traffic, work
    read = manifest.Manifest().reader("kernel1.roofline_pct")
    s = np.array([1, 2, 3, 3, 5, 5, 0, 1])       # two pool calls of 4 pairs
    t = np.array([4, 4, 3, 9, 6, 7, 2, 2])
    win = traffic.Traffic(s, t, np.zeros(8, np.int8), 2)
    kind = "NVIDIA H100 80GB HBM3"
    ctx = {"mix": {"loop": "closed", "pairs_per_call": 4},
           "config": {"index": {"max_batch": 2}, "k_max": 8},
           "traffic": win, "calls": [0, 1, 0], "device_kind": kind,
           "trace": _trace({"stab_packed_kernel<4, false>": [1e-4, 6]})}
    peaks = work.PEAKS[kind]
    # call 0: (1→4, 2→4) and (3→3, 3→9); call 1: (5→6, 5→7), (0→2, 1→2)
    one = {(1, 2, 4, 4): (2 * 12 + 3 * 16 + 2 * 64, 2 * 73 + 2),
           (3, 3, 3, 9): (2 * 12 + 2 * 16 + 1 * 64, 1 * 73 + 2),
           (5, 5, 6, 7): (2 * 12 + 3 * 16 + 1 * 64, 2 * 73 + 2),
           (0, 1, 2, 2): (2 * 12 + 3 * 16 + 2 * 64, 2 * 73 + 2)}
    for (a, b, c, d), want in one.items():
        assert work.stab_packed(np.array([a, b]), np.array([c, d]), 8) == want
    b = {key: work.bound_s(*w, peaks) for key, w in one.items()}
    call0 = b[(1, 2, 4, 4)] + b[(3, 3, 3, 9)]
    call1 = b[(5, 5, 6, 7)] + b[(0, 1, 2, 2)]
    want = 100 * (2 * call0 + call1) / 1e-4
    assert read(ctx) == pytest.approx(want)
    ctx["trace"]["kernels"] = {"stab_packed_kernel<4, false>": [1e-4, 5]}
    assert read(ctx) is None                 # a launch the calls do not own
    ctx["device_kind"] = "cpu"
    assert read(ctx) is None
