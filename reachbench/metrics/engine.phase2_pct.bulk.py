"""The engine's phase-2 share over the window: pairs that phase 1 (kernel
1) left UNKNOWN, over the pairs it classified (``SessionStats``), in
percent."""


def read(ctx):
    st = ctx["session"]
    if not st["n_queries"]:
        return None
    return 100.0 * st["phase2_queries"] / st["n_queries"]
