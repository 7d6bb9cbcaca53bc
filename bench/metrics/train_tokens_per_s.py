"""train_tokens_per_s: Tokens of every whole training step of the window
over its time."""

from bench import readers


def read(run):
    return readers.rate(run, "train")
