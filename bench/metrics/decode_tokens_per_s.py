"""decode_tokens_per_s: Tokens of every decode step of the window over its
time."""

from bench import readers


def read(run):
    return readers.rate(run, "decode")
