"""``idle_share``: the share of the traced epochs (after the profiler's
first) in which no kernel, copy or set ran on the device, in %."""


def read(ctx):
    t = ctx.trace
    if not t.get("window_s") or not t.get("busy_s"):
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
