"""device_idle.prefill: Share of the traced window with no kernel running,
in a prefill cell."""

from bench import readers


def read(run):
    return readers.device_idle(run, "prefill")
