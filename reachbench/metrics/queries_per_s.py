"""Pairs answered over the seconds of a closed loop's window: every call
served, to the end of the last one (host clock)."""


def read(ctx):
    if ctx["mix"]["loop"] != "closed":
        return None
    return ctx["host"]["pairs"] / ctx["host"]["window_s"]
