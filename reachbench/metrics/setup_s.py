"""Seconds from the process's start to the first timed request: the graph
from the seed, the index build, pack and ELL layout, the session, the
traffic and the warm-up (host clock)."""


def read(ctx):
    return ctx["host"]["setup_s"]
