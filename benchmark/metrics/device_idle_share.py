"""Share of the unprofiled window's wall time in which no device operation
ran: 100 x (1 - the device's busy seconds per step x the window's steps
over the window's seconds).  The busy seconds per step are the union of
the kernel, copy and set intervals over a stretch of steps traced on the
device alone; its wall time is not used, since even that tracing slows a
host-bound step."""

UNIT = "%"


def read(ctx):
    tr, w = ctx["trace"], ctx["window"]
    if tr["busy_s"] <= 0 or not tr.get("busy_steps") or not w["steps"] or ctx["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["busy_steps"] * w["steps"] / ctx["window_s"])
