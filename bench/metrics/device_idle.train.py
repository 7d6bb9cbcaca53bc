"""device_idle.train: Share of the traced window with no kernel running, in
a training cell."""

from bench import readers


def read(run):
    return readers.device_idle(run, "train")
