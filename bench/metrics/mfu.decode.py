"""mfu.decode: The window's share of the peaks: each decode step's frozen
least time (``costs.decode_step_least_s`` at its position) over the
window's time."""

from bench import readers


def read(run):
    return readers.mfu(run, "decode")
