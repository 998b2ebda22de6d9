"""``FrontendStats.occupancy`` over the window: real pairs over padded
bucket slots of the device slabs the frontend cut, in percent."""


def read(ctx):
    fe = ctx.get("frontend")
    if fe is None or not fe["batch_slots"]:
        return None
    return 100.0 * fe["occupancy"]
