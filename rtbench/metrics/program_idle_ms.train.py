"""Device milliseconds a profiled step in which the device ran nothing while
the host was inside the program's ``rt.step`` span: each span's length less
the union of device activity clipped to it (CUPTI and the host annotations
on one clock), mean over the profiled steps."""

from rtbench.spans import device_idle_in_spans_us


def read(ctx):
    if ctx.kind != "steps" or not ctx.events:
        return None
    idle = device_idle_in_spans_us(ctx.events, "rt.step")
    if not idle:
        return None
    return sum(idle) / 1e3 / len(idle)
