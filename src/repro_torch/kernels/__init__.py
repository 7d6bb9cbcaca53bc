"""Sequence kernels of the data plane: flash attention and the Mamba-1
selective scan (hand-written CUDA in ``csrc/``, plain torch in ``ref``)."""
