"""Production meshes.  Functions, not module constants: importing this module
touches no device or process-group state."""

from __future__ import annotations

import torch


def make_production_mesh(*, multi_pod: bool = False, device_type: str = None):
    """Single pod: 256 devices (16,16) over ("data","model").
    Multi-pod: 2 pods = 512 devices (2,16,16) over ("pod","data","model").
    Built on the process group the caller set up (its world size must be
    256 or 512; the dry-run's is a fake group); ``device_type`` defaults to
    the card, and raises when there is none (pass ``"cpu"`` for a mesh on
    the CPU)."""
    from torch.distributed.device_mesh import init_device_mesh

    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return init_device_mesh(device_type or _device_type(), shape,
                            mesh_dim_names=axes)


def make_local_mesh(model_parallel: int = 1, device_type: str = None):
    """Mesh over the caller's process group (one H100: ``(1, 1)``);
    ``device_type`` as in :func:`make_production_mesh`."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    n = dist.get_world_size()
    if n % model_parallel:
        raise ValueError(f"{n} devices do not split into model_parallel="
                         f"{model_parallel}")
    return init_device_mesh(device_type or _device_type(),
                            (n // model_parallel, model_parallel),
                            mesh_dim_names=("data", "model"))


def _device_type() -> str:
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device for the mesh; pass "
                           "device_type='cpu' for a mesh on the CPU")
    return "cuda"
