"""qwen2.5-32b — dense GQA with QKV bias [hf:Qwen/Qwen2.5-32B]."""
from .base import ModelConfig, dense_layout, register


def full() -> ModelConfig:
    return ModelConfig(
        name="qwen2.5-32b", family="dense",
        n_layers=64, d_model=5120, n_heads=40, n_kv_heads=8,
        d_ff=27648, vocab_size=152064, qkv_bias=True, rope_theta=1e6,
        layout=dense_layout(64), scan_period=1,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="qwen2.5-32b-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=8, n_kv_heads=2,
        d_ff=192, vocab_size=256, qkv_bias=True, rope_theta=1e6,
        layout=dense_layout(2), scan_period=1,
    )


register("qwen2.5-32b", full, smoke)
