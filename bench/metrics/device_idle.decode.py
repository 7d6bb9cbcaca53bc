"""device_idle.decode: Share of the traced window with no kernel running,
in a decode cell."""

from bench import readers


def read(run):
    return readers.device_idle(run, "decode")
