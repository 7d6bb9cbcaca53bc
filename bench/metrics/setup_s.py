"""setup_s: Set-up seconds: from the process's start to the window's
(imports, the kernels' build on a first run, weights, warm-up)."""


def read(run):
    return run.setup_s
