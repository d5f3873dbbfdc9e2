"""Per cent by which the slowest rank's device milliseconds a step in the
program's own kernels (``rt_tpu_torch/csrc``) exceed the mean over the
ranks, from each rank's trace of the profiled steps (CUPTI).  The ranks'
pixel bands hold unequal work, and the slowest sets the step."""

from rtbench.devtrace import device_events, kernel_base


def read(ctx):
    ranks = getattr(ctx, "rank_events", None)
    if ctx.kind != "steps" or not ranks or len(ranks) < 2:
        return None
    own = [sum(float(e["dur"]) for e in device_events(ev) if kernel_base(e["name"]) in ctx.csrc)
           for ev in ranks]
    if min(own) <= 0.0:
        return None
    return 100.0 * (max(own) / (sum(own) / len(own)) - 1.0)
