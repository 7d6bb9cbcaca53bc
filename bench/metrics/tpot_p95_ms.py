"""tpot_p95_ms: 95th percentile of the gap between output tokens over every
decode step of the window (CUDA events after each step's argmax)."""

from bench import readers


def read(run):
    return readers.tpot_p95_ms(run)
