"""Per cent: the least time of the profiled steps' work (rtbench.counts, on
the live work the reference counts) over the device time of the program's
own kernels in them (CUPTI)."""

from rtbench.counts import bound_ms
from rtbench.devtrace import device_events, kernel_base


def read(ctx):
    if ctx.kind != "steps" or not ctx.events or not ctx.work:
        return None
    own_ms = sum(float(e["dur"]) for e in device_events(ctx.events)
                 if kernel_base(e["name"]) in ctx.csrc) / 1e3
    if own_ms <= 0.0:
        return None
    return 100.0 * sum(bound_ms(b, ops) for b, ops in ctx.work) / own_ms
