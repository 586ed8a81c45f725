"""The host's share of an eager step: 1 - graph ms / eager ms of the traced
steps."""

from benchmark import readers


def read(ctx):
    return readers.host_share(ctx)
