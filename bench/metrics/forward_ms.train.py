"""forward_ms.train: Device ms a traced step in the port's ``forward`` span
(the embedding, every layer, the final norm and the unembedding), under
``train_step``: CUDA events on the compute stream."""

from bench import span_readers


def read(run):
    return span_readers.span_ms(run, "train", "train_step", "forward")
