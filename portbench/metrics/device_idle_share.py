"""device: 1 - the union of device activity (kernels, copies, memsets)
over the profiled stretch's host-clock length, %."""


def read(ctx):
    tr = ctx.get("trace")
    if not tr or not tr.get("window_s") or not tr.get("busy_s"):
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
