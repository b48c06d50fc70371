"""The plane build's upload rate: the bytes it uploads (the counter
plane_build.h2d_bytes) summed over the window's jobs, over the seconds of
their plane_build.upload spans, in GB/s."""

from benchmark.spans import count_rate


def read(ctx):
    rate = count_rate(ctx, "plane_build.h2d_bytes", "plane_build.upload")
    return None if rate is None else rate / 1e9
