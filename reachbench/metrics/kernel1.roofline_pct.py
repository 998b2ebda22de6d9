"""Kernel 1's share of its roofline over a closed loop's traced window, in
percent: the least time the card could take for every phase-1 call of the
window (``work.stab_packed`` on each micro-batch's pairs, the
configuration's ``k_max``, the card's peaks) over the profiler's time of
those calls. Nothing is read where the card has no entry in
``work.PEAKS``, or where the trace's kernel-1 launches are not one a
micro-batch of the calls served."""
from reachbench import work
from reachbench.devtrace import base_name


def read(ctx):
    tr, peaks = ctx.get("trace"), work.PEAKS.get(ctx.get("device_kind"))
    if tr is None or peaks is None or ctx["mix"]["loop"] != "closed":
        return None
    spent, launches = 0.0, 0
    for name, (sec, count) in tr["kernels"].items():
        if base_name(name) in work.KERNEL1:
            spent += sec
            launches += count
    win, calls = ctx["traffic"], ctx["calls"]
    q = int(ctx["mix"]["pairs_per_call"])
    mb = int(ctx["config"]["index"]["max_batch"])
    k = int(ctx["config"]["k_max"])
    if not spent or launches != len(calls) * -(-q // mb):
        return None
    per_call = {}
    for c in set(calls):
        s, t = win.s[c * q:(c + 1) * q], win.t[c * q:(c + 1) * q]
        per_call[c] = sum(
            work.bound_s(*work.stab_packed(s[lo:lo + mb], t[lo:lo + mb], k),
                         peaks) for lo in range(0, q, mb))
    return 100.0 * sum(per_call[c] for c in calls) / spent
