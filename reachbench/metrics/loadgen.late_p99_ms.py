"""How late the generator sent its requests: the 99th percentile, nearest
rank, of send time minus due time (host clock). The one-thread generator
sends only between the frontend's polls, so a long poll shows here."""
from reachbench.harness import p99


def read(ctx):
    late = ctx["host"].get("late_s")
    return None if late is None else p99(late) * 1e3
