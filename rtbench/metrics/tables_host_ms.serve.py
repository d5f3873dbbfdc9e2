"""Host milliseconds a profiled frame inside the program's ``rt.tables``
spans (the per-frame table build: the scene flattened into padded rows and
uploaded), from the profiled frames' trace."""

from rtbench.spans import covered_us, host_spans


def read(ctx):
    if ctx.kind != "frames" or not ctx.events:
        return None
    spans = [(a, b) for a, b, _, _ in host_spans(ctx.events, "rt.tables")]
    if not spans:
        return None
    return covered_us(spans, spans[0][0], max(b for _, b in spans)) / 1e3 / ctx.profiled
