"""The span plane_build.split of the discover report (split_words of every
slab of the plane build, with the first-touch reads of the memory-mapped
targets), mean per job of the window."""

from benchmark.spans import span_mean


def read(ctx):
    return span_mean(ctx, "plane_build.split")
