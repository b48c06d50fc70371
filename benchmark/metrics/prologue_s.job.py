"""The span prologue of the discover report (the host prologue of
engine.discover: GC filter, guide objects, sort, guide words), mean per job
of the window."""

from benchmark.spans import span_mean


def read(ctx):
    return span_mean(ctx, "prologue")
