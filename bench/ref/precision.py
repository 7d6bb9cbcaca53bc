"""The matrix products of the plain reference, in the precision asked for.

``"float32"`` is the reference: float32 operands with TF32 off
(:func:`strict_float32` sets the flags before any reference runs on the
card).  ``"fp8"`` is the control, the step below the bfloat16 that the
configurations state: each operand of every product is rounded to
float8 e4m3 under a scale of its own (its largest magnitude onto 448, the
format's largest finite value) and the product is taken in float32.  The
rounding passes gradients straight through, so a training step can run in
it too.
"""

from __future__ import annotations

import torch

#: the largest finite float8 e4m3 value
FP8_MAX = 448.0
MODES = ("float32", "fp8")


def strict_float32() -> None:
    """float32 products in float32: TF32 off for matmuls and convolutions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 under a per-tensor scale, as float32;
    the gradient passes through unchanged."""
    xd = x.detach()
    scale = xd.abs().amax().clamp(min=1e-30) / FP8_MAX
    q = (xd / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale
    return x + (q - xd)


class Precision:
    """The products of one reference run."""

    def __init__(self, mode: str = "float32"):
        if mode not in MODES:
            raise ValueError(f"precision {mode!r}; expected one of {MODES}")
        self.mode = mode

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.mode == "fp8":
            a, b = fp8_round(a), fp8_round(b)
        return a @ b
