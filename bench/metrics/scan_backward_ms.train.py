"""scan_backward_ms.train: Device ms a traced step under the autograd node
of the port's scan (``SelectiveScanBackward``: the plain
``scan_backward``)."""

from bench import readers


def read(run):
    return readers.node_ms(run, "train", "SelectiveScanBackward")
