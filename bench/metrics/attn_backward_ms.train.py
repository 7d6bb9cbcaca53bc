"""attn_backward_ms.train: Device ms a traced step under the autograd node
of the port's attention (``FlashAttentionBackward``: the plain
``flash_bwd_chunked``)."""

from bench import readers


def read(run):
    return readers.node_ms(run, "train", "FlashAttentionBackward")
