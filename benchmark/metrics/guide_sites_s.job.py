"""The discover report's `guide_sites_s`, mean per job of the window."""

from benchmark.readers import report_mean


def read(ctx):
    return report_mean(ctx, "guide_sites_s")
