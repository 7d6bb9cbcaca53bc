"""internvl2-1b — VLM: Qwen2-0.5B-style LM backbone; the InternViT frontend
is a STUB per the assignment (`input_specs()` feeds precomputed patch
embeddings as a 256-position prefix) [arXiv:2404.16821].

vocab 151655 padded to 151680 (multiple of 128) for clean model-axis sharding.
"""
from .base import ModelConfig, dense_layout, register


def full() -> ModelConfig:
    return ModelConfig(
        name="internvl2-1b", family="vlm",
        n_layers=24, d_model=896, n_heads=14, n_kv_heads=2,
        d_ff=4864, vocab_size=151680, qkv_bias=True, rope_theta=1e6,
        tie_embeddings=True, input_mode="vlm", vision_prefix=256,
        layout=dense_layout(24), scan_period=1,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="internvl2-1b-smoke", family="vlm",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=128, vocab_size=256, qkv_bias=True, rope_theta=1e6,
        tie_embeddings=True, input_mode="vlm", vision_prefix=8,
        layout=dense_layout(2), scan_period=1,
    )


register("internvl2-1b", full, smoke)
