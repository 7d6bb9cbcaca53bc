"""Weights from the seed, made by the benchmark and handed to both sides.

:func:`make` walks a schema (``bench.ref.model.schema``) in order and
yields ``(name, float32 tensor)``.  Normal leaves are drawn from one
``torch.Generator`` on the device, consecutive ones in one call of up to
``CHUNK`` values (a few dozen calls for a model), so the same seed and
schema give the same weights on a card, and the reference can draw them
again after the program is gone.  Yielded tensors may be views of one
drawn buffer: copy what is kept.
"""

from __future__ import annotations

import math
from typing import Iterator, Tuple

import torch

#: values drawn in one call at most (1 GiB of float32)
CHUNK = 1 << 28


def _fixed(shape, init, device) -> torch.Tensor:
    if init[0] == "ones":
        return torch.ones(shape, device=device)
    if init[0] == "zeros":
        return torch.zeros(shape, device=device)
    if init[0] == "const":
        return torch.full(shape, float(init[1]), device=device)
    if init[0] == "a_log":          # log(1..N) in every row
        n = shape[-1]
        return torch.log(torch.arange(1, n + 1, dtype=torch.float32,
                                      device=device)).expand(shape)
    raise ValueError(f"unknown init {init!r}")


def generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed % (1 << 63))


def make(schema, seed: int, device) -> Iterator[Tuple[str, torch.Tensor]]:
    gen = generator(seed, device)
    pending = []

    def draw():
        if not pending:
            return
        total = sum(math.prod(shape) for _, shape, _ in pending)
        buf = torch.empty(total, device=device).normal_(generator=gen)
        at = 0
        for name, shape, init in pending:
            n = math.prod(shape)
            yield name, buf[at:at + n].view(shape).mul_(init[1])
            at += n
        pending.clear()

    for name, shape, init in schema:
        if init[0] != "normal":
            yield from draw()
            yield name, _fixed(shape, init, device)
            continue
        if pending and (sum(math.prod(s) for _, s, _ in pending)
                        + math.prod(shape) > CHUNK):
            yield from draw()
        pending.append((name, shape, init))
    yield from draw()
