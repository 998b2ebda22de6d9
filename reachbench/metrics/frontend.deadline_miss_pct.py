"""The share of the window's admitted requests that the frontend completed
after their deadline (``FrontendStats.deadline_misses`` over requests), in
percent."""


def read(ctx):
    fe = ctx.get("frontend")
    if fe is None:
        return None
    requests = sum(t["requests"] for t in fe["tenants"].values())
    return None if not requests else 100.0 * fe["deadline_misses"] / requests
