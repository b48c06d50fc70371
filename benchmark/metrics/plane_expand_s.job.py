"""The span plane_build.expand of the discover report (the expand of the
packed words into code planes on the card, and the build's closing wait for
the card), mean per job of the window."""

from benchmark.spans import span_mean


def read(ctx):
    return span_mean(ctx, "plane_build.expand")
