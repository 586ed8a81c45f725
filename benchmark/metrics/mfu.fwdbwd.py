"""The step's least operations at the card's peak rates over the eager step
time."""

from benchmark import readers


def read(ctx):
    return readers.mfu(ctx)
