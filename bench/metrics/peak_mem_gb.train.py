"""peak_mem_gb.train: Allocator peak inside the window
(``max_memory_allocated`` after ``reset_peak_memory_stats``), in a
training cell."""

from bench import readers


def read(run):
    return readers.peak_mem_gb(run, "train")
