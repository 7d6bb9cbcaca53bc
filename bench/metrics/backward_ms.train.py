"""backward_ms.train: Device ms a traced step in the port's ``backward``
span (``torch.autograd.grad``: every gradient, the remat recompute
included), under ``train_step``: CUDA events on the compute stream."""

from bench import span_readers


def read(run):
    return span_readers.span_ms(run, "train", "train_step", "backward")
