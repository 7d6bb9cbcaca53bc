"""mixer_ms.prefill: Device ms a traced request in the port's ``mixer``
spans (each layer's norm, attention or Mamba and residual add; one a
layer), under ``prefill``: CUDA events on the compute stream."""

from bench import span_readers


def read(run):
    return span_readers.span_ms(run, "prefill", "prefill", "mixer",
                                span_readers.layers(run, "mixer"))
