"""flash_attention_roofline.prefill: The bf16 attention kernel's launches
of the traced requests: each launch's frozen least time
(``costs.attn_least_s`` at B x the prompt, causal) over the device time
of the kernels named ``flash_wgmma_kernel``."""

from bench import costs, readers

PATTERN = r"flash_wgmma_kernel"


def read(run):
    if run.kind != "prefill":
        return None
    least = costs.attn_least_s(*readers.attention_shape(run, "prompt"), elem=2)
    return readers.kernel_roofline(run, "prefill", PATTERN, least)
