"""The discover report's `counter_s` (the comparison counter on the card),
mean per job of the window."""

from benchmark.readers import report_mean


def read(ctx):
    return report_mean(ctx, "counter_s")
