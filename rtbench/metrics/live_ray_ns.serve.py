"""Device nanoseconds of the wavefront's later-bounce kernel
(``wf_bounce_kernel``, row 8 at bounces 1 and on) in the profiled frames,
over the live rays that entered those bounces, as the program counted them
while the session recorded (``rt_tpu_torch.profiling.live_rays``)."""

from rtbench.devtrace import device_events, kernel_base


def read(ctx):
    if ctx.kind != "frames" or not ctx.events:
        return None
    try:
        from rt_tpu_torch import profiling
    except ImportError:
        return None
    live_rays = getattr(profiling, "live_rays", None)
    if live_rays is None:
        return None
    live = sum(live_rays()[1:])
    ns = 1e3 * sum(float(e["dur"]) for e in device_events(ctx.events)
                   if kernel_base(e["name"]) == "wf_bounce_kernel")
    if live <= 0 or ns <= 0.0:
        return None
    return ns / live
