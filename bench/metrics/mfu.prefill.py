"""mfu.prefill: The window's share of the peaks: each request's frozen
least time (``costs.prefill_least_s``) over the window's time."""

from bench import readers


def read(run):
    return readers.mfu(run, "prefill")
