"""The traced window's share with no kernel, copy or memset running."""

from benchmark import readers


def read(ctx):
    return readers.idle(ctx)
