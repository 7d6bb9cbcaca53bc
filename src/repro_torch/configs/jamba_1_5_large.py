"""jamba-1.5-large-398b — hybrid Mamba+attention 1:7, MoE 16e top-2
[arXiv:2403.19887].  72 layers = 9 scanned periods of 8 (attn at period
position 4, MoE on odd positions)."""
from .base import ModelConfig, jamba_layout, register


def full() -> ModelConfig:
    return ModelConfig(
        name="jamba-1.5-large-398b", family="hybrid",
        n_layers=72, d_model=8192, n_heads=64, n_kv_heads=8,
        d_ff=24576, vocab_size=65536,
        n_experts=16, n_experts_active=2, moe_d_ff=24576,
        ssm_state=16, ssm_conv=4, ssm_expand=2,
        layout=jamba_layout(72), scan_period=8,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="jamba-1.5-large-398b-smoke", family="hybrid",
        n_layers=8, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=128, vocab_size=256,
        n_experts=4, n_experts_active=2, moe_d_ff=128,
        ssm_state=8, ssm_conv=4, ssm_expand=2,
        layout=jamba_layout(8), scan_period=8,
    )


register("jamba-1.5-large-398b", full, smoke)
