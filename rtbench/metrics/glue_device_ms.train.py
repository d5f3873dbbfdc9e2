"""Device milliseconds a step in every operation that is not a kernel of the
program's hand-written CUDA sources (torch's sorts, gathers, sums, copies and
the optimizer), from the profiled steps' CUPTI trace."""

from rtbench.devtrace import device_events, kernel_base


def read(ctx):
    if ctx.kind != "steps" or not ctx.events:
        return None
    dev = device_events(ctx.events)
    if not dev:
        return None
    glue = sum(float(e["dur"]) for e in dev if kernel_base(e["name"]) not in ctx.csrc)
    return glue / 1e3 / ctx.profiled
