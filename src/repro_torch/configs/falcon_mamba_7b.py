"""falcon-mamba-7b — attention-free Mamba-1 SSM [arXiv:2410.05355]."""
from .base import ModelConfig, mamba_layout, register


def full() -> ModelConfig:
    return ModelConfig(
        name="falcon-mamba-7b", family="ssm",
        n_layers=64, d_model=4096, n_heads=1, n_kv_heads=1,
        d_ff=0, vocab_size=65024, ssm_state=16, ssm_conv=4, ssm_expand=2,
        layout=mamba_layout(64), scan_period=1,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="falcon-mamba-7b-smoke", family="ssm",
        n_layers=2, d_model=64, n_heads=1, n_kv_heads=1,
        d_ff=0, vocab_size=256, ssm_state=8, ssm_conv=4, ssm_expand=2,
        layout=mamba_layout(2), scan_period=1,
    )


register("falcon-mamba-7b", full, smoke)
