"""mamba_scan_roofline.train: The scan kernel's launches of the traced
steps: each launch's frozen least time (``costs.scan_least_s`` at B x S
x d_inner x N, bf16) over the device time of the kernels named
``scan_kernel<...>``."""

from bench import costs, readers

PATTERN = r"(^|[\s:])scan_kernel<"


def read(run):
    if run.kind != "train":
        return None
    cfg, tr = run.cell.config, run.cell.traffic
    least = costs.scan_least_s(tr["batch"], tr["seq"],
                               cfg["expand"] * cfg["hidden_size"],
                               cfg["state_size"], elem=2)
    return readers.kernel_roofline(run, "train", PATTERN, least)
