"""The discover report's `upload_expand_s`, mean per job of the window."""

from benchmark.readers import report_mean


def read(ctx):
    return report_mean(ctx, "upload_expand_s")
