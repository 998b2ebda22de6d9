"""Reading a profiler window: the device's busy time, each kernel's time,
and the idle gaps labelled by what the harness was doing.

The busy-share arithmetic follows the port's smoke run
(``chip_smoke.py::profile_window``): device events of the profiler against
the window's length. Here the events are merged into their union before
they are summed, so copies and kernels that overlap count once, and the
window is the harness's own ``reachbench.window`` span in the same trace.
The harness's spans (``record_function`` ranges named ``reachbench.*``)
label the idle time by what the host was doing: each gap's time goes to
the spans that overlap it ("none": between spans).

The sparse phase 2 runs kernels 3 and 4 as nodes of a CUDA graph's while
loop, which the profiler lists only in part: ``kernel3_traced`` counts the
trace's kernel-3 events, for each run to print beside the launches the
kernel counted itself. Where they differ, ``busy_s`` is a lower bound.
"""
from __future__ import annotations

from collections import defaultdict

import numpy as np

WINDOW = "reachbench.window"
PREFIX = "reachbench."
KERNEL3 = "expand_probe_kernel"


def _ns(e, which: str) -> int:
    fn = getattr(e, f"{which}_ns", None)
    if fn is not None:
        return int(fn())
    return int(getattr(e, f"{which}_us")() * 1000)


def events(prof):
    """(name, is_device, start_ns, end_ns) of the device's work (kernels,
    copies, sets) and of the host's ``reachbench.*`` spans that a stopped
    ``torch.profiler.profile`` recorded. A range a ``record_function``
    projects onto the device is neither."""
    from torch.autograd import DeviceType
    out = []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        on_host = e.device_type() == DeviceType.CPU
        if on_host != name.startswith(PREFIX):
            continue                      # a host op, or a projected range
        if not on_host and getattr(e, "is_user_annotation", bool)():
            continue
        start = _ns(e, "start")
        out.append((name, not on_host, start, start + _ns(e, "duration")))
    return out


def kernel_name(name: str) -> str:
    """A device event's name without its return type and argument list
    ("unnamed" where the profiler gives none)."""
    if name.endswith(")"):
        depth = 0
        for i in range(len(name) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(name[i], 0)
            if depth == 0:
                name = name[:i]
                break
    name = name.strip()
    return (name[5:] if name.startswith("void ") else name) or "unnamed"


def base_name(kernel: str) -> str:
    """A kernel's own name: ``kernel_name``'s without its namespaces and
    template arguments (``(anonymous namespace)::k<4, false>`` -> ``k``)."""
    name = kernel.split("<", 1)[0]
    return name.rsplit("::", 1)[-1].strip()


def _union(intervals):
    merged = []
    for lo, hi in sorted(intervals):
        if merged and lo <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], hi)
        else:
            merged.append([lo, hi])
    return merged


def summarize(evts, top: int = 10) -> dict:
    """busy_s, window_s, per-kernel [seconds, count] and the breakdown's
    two lists, from ``events``' output. Device events outside the window
    are left out, and those that cross its edges are cut at them."""
    win = [(s, e) for name, dev, s, e in evts if name == WINDOW and not dev]
    if len(win) != 1:
        raise ValueError(f"{len(win)} {WINDOW} spans in the trace, not 1")
    w0, w1 = win[0]
    kernels = defaultdict(lambda: [0.0, 0])
    spans, dev = [], []
    for name, is_dev, s, e in evts:
        if is_dev:
            lo, hi = max(s, w0), min(e, w1)
            if hi <= lo:
                continue
            dev.append((lo, hi))
            row = kernels[kernel_name(name)]
            row[0] += (hi - lo) / 1e9
            row[1] += 1
        elif name.startswith(PREFIX) and name != WINDOW:
            spans.append((s, e, name[len(PREFIX):]))
    busy = _union(dev)
    busy_s = sum(hi - lo for lo, hi in busy) / 1e9
    gaps, prev = [], w0
    for lo, hi in busy + [[w1, w1]]:
        if lo > prev:
            gaps.append((prev, lo))
        prev = max(prev, hi)
    # the harness's spans are flat (one thread, none inside another): each
    # gap's time goes to the spans it overlaps, the rest to "none"
    spans.sort()
    starts = np.array([s for s, _, _ in spans], dtype=np.int64)
    idle = defaultdict(float)
    for lo, hi in gaps:
        i = max(0, int(np.searchsorted(starts, lo, side="right")) - 1)
        covered = 0
        while i < len(spans) and spans[i][0] < hi:
            part = min(hi, spans[i][1]) - max(lo, spans[i][0])
            if part > 0:
                idle[spans[i][2]] += part / 1e9
                covered += part
            i += 1
        if hi - lo > covered:
            idle["none"] += (hi - lo - covered) / 1e9
    ops = sorted(((k, v[0]) for k, v in kernels.items()),
                 key=lambda kv: -kv[1])
    return {"busy_s": busy_s, "window_s": (w1 - w0) / 1e9,
            "kernels": {k: list(v) for k, v in kernels.items()},
            "breakdown": {
                "device_ops": [[k, s] for k, s in ops[:top]],
                "idle_gaps": sorted(([k, s] for k, s in idle.items()),
                                    key=lambda kv: -kv[1])[:top]}}


def kernel3_traced(trace: dict) -> int:
    """Kernel 3's events in ``summarize``'s window."""
    return sum(count for name, (_, count) in trace["kernels"].items()
               if base_name(name) == KERNEL3)

