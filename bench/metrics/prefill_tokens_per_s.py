"""prefill_tokens_per_s: Prompt tokens of every whole request of the window
(prefill and the first token read back) over its time."""

from bench import readers


def read(run):
    return readers.rate(run, "prefill")
