"""Device milliseconds a profiled frame in which the device ran nothing while
the host was inside the program's ``rt.frame`` span: each span's length less
the union of device activity clipped to it (CUPTI and the host annotations
on one clock), mean over the profiled frames."""

from rtbench.spans import device_idle_in_spans_us


def read(ctx):
    if ctx.kind != "frames" or not ctx.events:
        return None
    idle = device_idle_in_spans_us(ctx.events, "rt.frame")
    if not idle:
        return None
    return sum(idle) / 1e3 / len(idle)
