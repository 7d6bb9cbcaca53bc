"""qwen3-moe-30b-a3b — 128-expert top-8 MoE, GQA kv=4, head_dim 128
[hf:Qwen/Qwen3-30B-A3B].  (Qwen3's q/k-norm is omitted; noted in DESIGN.md.)"""
from .base import ModelConfig, moe_layout, register


def full() -> ModelConfig:
    return ModelConfig(
        name="qwen3-moe-30b-a3b", family="moe",
        n_layers=48, d_model=2048, n_heads=32, n_kv_heads=4, head_dim=128,
        d_ff=768, vocab_size=151936, rope_theta=1e6,
        n_experts=128, n_experts_active=8, moe_d_ff=768,
        layout=moe_layout(48), scan_period=1,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="qwen3-moe-30b-a3b-smoke", family="moe",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=96, vocab_size=256, rope_theta=1e6,
        n_experts=8, n_experts_active=2, moe_d_ff=96,
        layout=moe_layout(2), scan_period=1,
    )


register("qwen3-moe-30b-a3b", full, smoke)
