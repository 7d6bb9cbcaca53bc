"""ffn_ms.prefill: Device ms a traced request in the port's ``ffn`` spans
(each layer's norm, MLP or MoE and residual add; one a layer that has an
FFN), under ``prefill``: CUDA events on the compute stream."""

from bench import span_readers


def read(run):
    return span_readers.span_ms(run, "prefill", "prefill", "ffn",
                                span_readers.layers(run, "ffn"))
