"""The share of every request of an open loop's window that was answered
within the mix's ``slo_ms`` of when it was due, in % (host clock). Each
request is timed as ``frontend.request_p95_ms`` times it; a request never
answered is late."""
import numpy as np


def read(ctx):
    lat = ctx["host"].get("latency_s")
    slo_ms = ctx["mix"].get("slo_ms")
    if lat is None or slo_ms is None:
        return None
    return float(np.mean(np.asarray(lat) <= slo_ms / 1e3) * 100)
