"""Per cent: the least time of the profiled steps' work (rtbench.counts, on
the live work the reference counts) over the device time of the program's
own kernels in them (CUPTI).  Over several ranks: the sum of each rank's
least time, on its own pixels, over the sum of the ranks' device time in
the program's own kernels."""

from rtbench.counts import bound_ms
from rtbench.devtrace import device_events, kernel_base


def read(ctx):
    if ctx.kind != "steps" or not ctx.events or not ctx.work:
        return None
    rank_events = getattr(ctx, "rank_events", None) or [ctx.events]
    rank_work = getattr(ctx, "rank_work", None) or [ctx.work]
    own_ms = sum(sum(float(e["dur"]) for e in device_events(ev)
                     if kernel_base(e["name"]) in ctx.csrc) for ev in rank_events) / 1e3
    if own_ms <= 0.0:
        return None
    return 100.0 * sum(bound_ms(b, ops) for work in rank_work for b, ops in work) / own_ms
