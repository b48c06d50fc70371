"""The window over the number of jobs that returned in it."""


def read(ctx):
    return ctx.window_s / len(ctx.reports) if ctx.reports else None
