"""Per cent of a step's wall time in which the device ran nothing: one less
the union of device activity a step (CUPTI, profiled steps) over the wall
milliseconds a step of the untraced window.  Over several ranks, rank 0's
card, and a collective's kernel (NCCL's, ``nccl*``) is not activity: it
spins while it waits for another rank."""

from rtbench.core import idle_share
from rtbench.devtrace import device_events, kernel_base, union_us


def read(ctx):
    if ctx.kind != "steps" or not ctx.events or not ctx.records:
        return None
    dev = [e for e in device_events(ctx.events) if not kernel_base(e["name"]).startswith("nccl")]
    if not dev:
        return None
    busy_ms = union_us(dev) / 1e3 / ctx.profiled
    return idle_share(busy_ms, 1e3 * ctx.window_s / len(ctx.records))
