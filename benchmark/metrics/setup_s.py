"""Process start to the first timed job: genome, index, job pool, kernels,
warm-up jobs."""


def read(ctx):
    return ctx.setup_s
