"""The write's rate: the bytes of the output files (the counter write.bytes)
summed over the window's jobs, over the seconds of their write spans, in
MB/s."""

from benchmark.spans import count_rate


def read(ctx):
    rate = count_rate(ctx, "write.bytes", "write")
    return None if rate is None else rate / 1e6
