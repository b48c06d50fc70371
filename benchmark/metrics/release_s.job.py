"""The span release of the discover report (the end of the call: the
database's memory maps, the planes and the guides freed), mean per job of
the window."""

from benchmark.spans import span_mean


def read(ctx):
    return span_mean(ctx, "release")
