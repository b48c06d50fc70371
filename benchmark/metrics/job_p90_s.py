"""The 90th percentile (nearest rank) of the wall of every job of the window,
from its start to the return of `cli.run`."""

from benchmark.readers import nearest_rank


def read(ctx):
    return nearest_rank(ctx.job_s, 0.9)
