"""Device milliseconds a step in the collectives' kernels (NCCL's, named
``nccl*``) of the profiled steps, the mean over the ranks (CUPTI, each
rank's own trace).  A rank that waits in the frame's gather for a slower
one counts that wait here."""

from rtbench.devtrace import device_events, kernel_base


def read(ctx):
    ranks = getattr(ctx, "rank_events", None)
    if ctx.kind != "steps" or not ranks or len(ranks) < 2:
        return None
    per_rank = [sum(float(e["dur"]) for e in device_events(ev)
                    if kernel_base(e["name"]).startswith("nccl")) for ev in ranks]
    if not any(per_rank):
        return None
    return sum(per_rank) / len(per_rank) / 1e3 / ctx.profiled
