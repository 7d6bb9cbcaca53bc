"""peak_mem_gb.prefill: Allocator peak inside the window, in a prefill
cell."""

from bench import readers


def read(run):
    return readers.peak_mem_gb(run, "prefill")
