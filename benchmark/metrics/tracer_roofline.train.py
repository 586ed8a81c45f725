"""The tracer kernels' least time for the reference's composited hits over
their traced time."""

from benchmark import readers


def read(ctx):
    return readers.roofline(ctx)
