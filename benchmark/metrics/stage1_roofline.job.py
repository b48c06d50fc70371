"""Stage 1's bound (work.py: real guides x 4 n_act x real targets) over the
device time of the kernels named `stage1_kernel` (csrc/stage1.cu), summed
over the window's jobs."""

from benchmark.readers import roofline


def read(ctx):
    return roofline(ctx, "stage1_kernel")
