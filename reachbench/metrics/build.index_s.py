"""Seconds of ``reach.build`` with the device builder (kernel 5), ended by
a synchronisation (host clock)."""


def read(ctx):
    return ctx["host"]["build_index_s"]
