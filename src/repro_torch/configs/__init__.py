"""Architecture registry: one module per assigned arch (+ reduced smoke twin).

``get_config(arch_id, smoke=False)`` is the public entry point; arch ids are
the assignment's ids (e.g. ``--arch qwen2.5-14b``).
"""

from .base import (ModelConfig, LayerSpec, InputShape, SHAPES,
                   shape_applicable, get_config, list_archs, register)

_LOADED = False


def _load_all() -> None:
    global _LOADED
    if _LOADED:
        return
    _LOADED = True
    from . import (internlm2_1_8b, qwen2_5_14b, stablelm_3b, qwen2_5_32b,
                   falcon_mamba_7b, jamba_1_5_large, internvl2_1b,
                   musicgen_large, qwen3_moe_30b, kimi_k2_1t)  # noqa: F401


__all__ = ["ModelConfig", "LayerSpec", "InputShape", "SHAPES",
           "shape_applicable", "get_config", "list_archs", "register"]
