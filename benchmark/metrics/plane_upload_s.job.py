"""The span plane_build.upload of the discover report (the host-to-device
copies of the plane build's packed words), mean per job of the window."""

from benchmark.spans import span_mean


def read(ctx):
    return span_mean(ctx, "plane_build.upload")
