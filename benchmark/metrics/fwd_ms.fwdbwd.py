"""Device ms per step inside the forward span: ops.tracer.trace (tile
inputs, forward kernels, tail pass, untile) and the loss."""

from benchmark import readers


def read(ctx):
    return readers.span_ms(ctx, "bench.fwd")
