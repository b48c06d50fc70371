"""The discover report's `write_s`, mean per job of the window."""

from benchmark.readers import report_mean


def read(ctx):
    return report_mean(ctx, "write_s")
