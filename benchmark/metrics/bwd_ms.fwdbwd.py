"""Device ms per step inside the backward span: autograd through trace (the
gathers' backward, the backward kernels)."""

from benchmark import readers


def read(ctx):
    return readers.span_ms(ctx, "bench.bwd")
