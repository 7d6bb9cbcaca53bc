"""mfu.train: The window's share of the bf16 peak: 6 N T + 3 x the
attention products a step (frozen, ``bench.costs``) over the window's
time."""

from bench import readers


def read(run):
    return readers.mfu(run, "train")
