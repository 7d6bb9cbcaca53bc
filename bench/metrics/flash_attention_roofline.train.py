"""flash_attention_roofline.train: The bf16 attention kernel's launches of
the traced steps: each launch's frozen least time
(``costs.attn_least_s`` at B x S, causal) over the device time of the
kernels named ``flash_wgmma_kernel``."""

from bench import costs, readers

PATTERN = r"flash_wgmma_kernel"


def read(run):
    if run.kind != "train":
        return None
    least = costs.attn_least_s(*readers.attention_shape(run, "seq"), elem=2)
    return readers.kernel_roofline(run, "train", PATTERN, least)
