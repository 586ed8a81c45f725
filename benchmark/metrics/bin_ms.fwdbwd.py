"""Device ms per step inside the harness's binning span (bin_tail_chain,
every rebin_every-th step), amortised over all steps."""

from benchmark import readers


def read(ctx):
    return readers.span_ms(ctx, "bench.bin")
