"""Frontier steps a sparse phase-2 call over the window, from the kernels'
own counters (``frontier_fused.STEPS``): the steps the device counted over
the calls, each call launching set-up and clean-up once (``helpers``)."""


def read(ctx):
    steps = ctx["steps"]
    calls = steps["helpers"] / 2
    return None if not calls else steps["steps"] / calls
