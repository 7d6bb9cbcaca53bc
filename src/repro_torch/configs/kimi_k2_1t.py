"""kimi-k2-1t-a32b — trillion-parameter MoE: 384 experts top-8 + 1 shared
expert, first layer dense (DeepSeek-V3 lineage) [arXiv:2501.kimi2].
head_dim 112 (= 7168/64); dense first-layer d_ff 18432."""
from .base import LayerSpec, ModelConfig, moe_layout, register


def full() -> ModelConfig:
    layout = (LayerSpec("attn", "mlp"),) + moe_layout(60)
    return ModelConfig(
        name="kimi-k2-1t-a32b", family="moe",
        n_layers=61, d_model=7168, n_heads=64, n_kv_heads=8,
        d_ff=18432, vocab_size=163840, rope_theta=50_000.0,
        n_experts=384, n_experts_active=8, moe_d_ff=2048,
        n_shared_experts=1,
        layout=layout, prefix_layers=1, scan_period=1,
    )


def smoke() -> ModelConfig:
    layout = (LayerSpec("attn", "mlp"),) + moe_layout(2)
    return ModelConfig(
        name="kimi-k2-1t-a32b-smoke", family="moe",
        n_layers=3, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=160, vocab_size=256, rope_theta=50_000.0,
        n_experts=8, n_experts_active=2, moe_d_ff=64,
        n_shared_experts=1,
        layout=layout, prefix_layers=1, scan_period=1,
    )


register("kimi-k2-1t-a32b", full, smoke)
