"""loss_ms.train: Device ms a traced step in the port's ``loss`` span (the
float32 cross-entropy and z-loss over the logits), under ``train_step``:
CUDA events on the compute stream."""

from bench import span_readers


def read(run):
    return span_readers.span_ms(run, "train", "train_step", "loss")
