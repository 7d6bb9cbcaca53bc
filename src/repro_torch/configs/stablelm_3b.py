"""stablelm-3b — dense MHA, LayerNorm, partial rotary [hf:stabilityai/stablelm-2]."""
from .base import ModelConfig, dense_layout, register


def full() -> ModelConfig:
    return ModelConfig(
        name="stablelm-3b", family="dense",
        n_layers=32, d_model=2560, n_heads=32, n_kv_heads=32,
        d_ff=6912, vocab_size=50304, norm="layernorm", rope_pct=0.25,
        layout=dense_layout(32), scan_period=1,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="stablelm-3b-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=128, vocab_size=256, norm="layernorm", rope_pct=0.25,
        layout=dense_layout(2), scan_period=1,
    )


register("stablelm-3b", full, smoke)
