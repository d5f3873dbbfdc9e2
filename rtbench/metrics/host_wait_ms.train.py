"""Host milliseconds a profiled step inside blocking CUDA runtime calls that
lie inside the program's ``rt.step`` span on the same thread, from the
profiled steps' trace.  The blocking calls, by the name the trace gives
them: ``cudaStreamSynchronize``, ``cudaDeviceSynchronize``,
``cudaEventSynchronize``, ``cudaMemcpy``, ``cudaHostAlloc``,
``cudaFreeHost``, ``cudaFree``."""

from rtbench.spans import covered_us, host_spans

BLOCKING = frozenset({"cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
                      "cudaMemcpy", "cudaHostAlloc", "cudaFreeHost", "cudaFree"})


def read(ctx):
    if ctx.kind != "steps" or not ctx.events:
        return None
    steps = host_spans(ctx.events, "rt.step")
    if not steps:
        return None
    waits = [(e.get("pid"), e.get("tid"), float(e["ts"]), float(e["ts"]) + float(e["dur"]))
             for e in ctx.events if e.get("cat") == "cuda_runtime" and e.get("name") in BLOCKING]
    total = sum(covered_us([(a, b) for p, t, a, b in waits if (p, t) == (pid, tid)], s, e)
                for s, e, pid, tid in steps)
    return total / 1e3 / len(steps)
