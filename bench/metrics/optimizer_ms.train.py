"""optimizer_ms.train: Device ms a traced step in the port's ``optimizer``
span (``optim.adamw_update``: the global norm, the clip and AdamW over
every leaf), under ``train_step``: CUDA events on the compute stream."""

from bench import span_readers


def read(run):
    return span_readers.span_ms(run, "train", "train_step", "optimizer")
