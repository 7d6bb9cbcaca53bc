"""The reference's five examples on the port, each a module that runs as
``python -m repro_torch.examples.<name>``:

- :mod:`.quickstart` — one provisioning decision and two baselines;
- :mod:`.provision_cluster` — a 48 h operations log of one pool;
- :mod:`.run_scenario` — the scenario engine's tour: record, replay, seed
  sweeps, the fleet, serving workloads, fault storms and regions;
- :mod:`.serve_batched` — prefill and greedy decode of any arch's smoke
  config;
- :mod:`.train_elastic_spot` — a ~100M-parameter LM trained through
  simulated spot interruptions.

Each prints what the reference's example prints.  The decision examples
solve on the process-default backend (``KUBEPACS_SOLVER_BACKEND``, the
card's ``torch`` unless set: ``torch:cpu`` or ``numpy`` on a host); the
two model examples run on the card unless ``--device cpu``.
"""

import contextlib
import re


def masked_walls(text: str, trace: str = None) -> str:
    """An example's stdout with the fields that print a wall (``0.22s``)
    or the fleet's rate (``(3206 replicas/s)``) masked, and ``trace`` named
    ``<trace>``: what two runs of one decision example print alike."""
    if trace:
        text = text.replace(trace, "<trace>")
    text = re.sub(r"\d+\.\d\ds\b", "<s>", text)
    return re.sub(r"\(\d+ replicas/s\)", "(<rate>)", text)


@contextlib.contextmanager
def recorded(module, name):
    """``module.name`` replaced, while the block runs, by a wrapper that
    keeps in the list yielded each instance made (a class) or each call's
    positional arguments (a function)."""
    orig = getattr(module, name)
    made = []
    if isinstance(orig, type):
        class Recorded(orig):
            def __init__(self, *args, **kw):
                super().__init__(*args, **kw)
                made.append(self)
        new = Recorded
    else:
        def new(*args, **kw):
            made.append(args)
            return orig(*args, **kw)
    setattr(module, name, new)
    try:
        yield made
    finally:
        setattr(module, name, orig)
