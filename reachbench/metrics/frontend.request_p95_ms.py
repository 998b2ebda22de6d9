"""The 95th percentile, nearest rank, of every request of an open loop's
window, each timed from when it was due to when its answers were handed
back (a request the frontend refused is sent again by its client, and its
time still runs from when it was due); a request never answered counts as
infinitely late (host clock; read in the traced run)."""
from reachbench.harness import percentile


def read(ctx):
    lat = ctx["host"].get("latency_s")
    return None if lat is None else percentile(lat, 95) * 1e3
