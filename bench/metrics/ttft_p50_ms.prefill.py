"""ttft_p50_ms.prefill: Median request wall of the window (host clock, to
the first token read back)."""

from bench import readers


def read(run):
    return readers.ttft_p50_ms(run)
