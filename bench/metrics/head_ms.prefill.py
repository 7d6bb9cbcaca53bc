"""head_ms.prefill: Device ms a traced request in the port's ``head`` span
(the final norm and the unembedding of every position), under
``prefill``: CUDA events on the compute stream."""

from bench import span_readers


def read(run):
    return span_readers.span_ms(run, "prefill", "prefill", "head")
