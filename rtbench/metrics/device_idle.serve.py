"""Per cent of a frame's wall time in which the device ran nothing: one less
the union of device activity a frame (CUPTI, profiled frames) over the wall
milliseconds a frame of the untraced window."""

from rtbench.core import idle_share
from rtbench.devtrace import device_events, union_us


def read(ctx):
    if ctx.kind != "frames" or not ctx.events or not ctx.records:
        return None
    dev = device_events(ctx.events)
    if not dev:
        return None
    busy_ms = union_us(dev) / 1e3 / ctx.profiled
    return idle_share(busy_ms, 1e3 * ctx.window_s / len(ctx.records))
