"""mamba_scan_bwd_roofline.train: The scan backward's launches of the
traced steps: each launch's frozen least time
(``backward_costs.scan_bwd_least_s`` at B x S x d_inner x N, bf16) over the
device time of the kernels it runs, ``scan_bwd_kernel<...>`` (one a launch,
which counts the launches) and ``scan_bwd_sums<...>`` (its sums across
CTAs). None where no such kernel ran (a program whose scan backward is no
kernel)."""

import re

from bench import backward_costs

LAUNCH = r"(^|[\s:])scan_bwd_kernel<"
PATTERN = r"(^|[\s:])scan_bwd_(kernel|sums)<"


def read(run):
    t = run.trace
    if run.kind != "train" or t is None:
        return None
    cfg, tr = run.cell.config, run.cell.traffic
    least = backward_costs.scan_bwd_least_s(
        tr["batch"], tr["seq"], cfg["expand"] * cfg["hidden_size"],
        cfg["state_size"], elem=2)
    n, _ = t.kernel_seconds(re.compile(LAUNCH).search)
    _, seconds = t.kernel_seconds(re.compile(PATTERN).search)
    if not n or seconds <= 0:
        return None
    return 100.0 * n * least / seconds
