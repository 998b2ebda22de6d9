"""Seconds of ``pack_index`` and the ELL layout of the built index (host
clock)."""


def read(ctx):
    return ctx["host"]["build_pack_s"]
