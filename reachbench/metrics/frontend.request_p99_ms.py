"""The 99th percentile, nearest rank, of every request of an open loop's
window, each timed as ``frontend.request_p95_ms`` times it (host clock;
read in the traced run). The few slabs a window whose phase 2 meets a hub set it."""
from reachbench.harness import p99


def read(ctx):
    lat = ctx["host"].get("latency_s")
    return None if lat is None else p99(lat) * 1e3
