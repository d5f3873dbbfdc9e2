"""Host milliseconds from a frame's request until the program's call returns,
mean over the untraced window (the entry layer's own time: routing, table
build, uploads, launches)."""


def read(ctx):
    if ctx.kind != "frames" or not ctx.records:
        return None
    return 1e3 * sum(ret - req for req, ret, _ in ctx.records) / len(ctx.records)
