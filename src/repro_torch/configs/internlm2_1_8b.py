"""internlm2-1.8b — dense GQA [arXiv:2403.17297]."""
from .base import ModelConfig, dense_layout, register


def full() -> ModelConfig:
    return ModelConfig(
        name="internlm2-1.8b", family="dense",
        n_layers=24, d_model=2048, n_heads=16, n_kv_heads=8,
        d_ff=8192, vocab_size=92544, rope_theta=1e6,
        layout=dense_layout(24), scan_period=1,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="internlm2-1.8b-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=128, vocab_size=256, rope_theta=1e6,
        layout=dense_layout(2), scan_period=1,
    )


register("internlm2-1.8b", full, smoke)
