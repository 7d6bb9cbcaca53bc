"""peak_mem_gb.decode: Allocator peak inside the window, in a decode cell."""

from bench import readers


def read(run):
    return readers.peak_mem_gb(run, "decode")
