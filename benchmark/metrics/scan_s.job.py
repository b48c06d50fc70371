"""The discover report's `scan_s`, mean per job of the window."""

from benchmark.readers import report_mean


def read(ctx):
    return report_mean(ctx, "scan_s")
