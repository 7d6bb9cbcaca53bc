"""musicgen-large — decoder-only over EnCodec tokens (4 codebooks, vocab 2048
each); the EnCodec frontend/delay-pattern is a STUB: `input_specs()` feeds
pre-interleaved code frames [arXiv:2306.05284].  Adaptation note (DESIGN.md):
MusicGen uses sinusoidal positions; we use RoPE, the substrate's native
position scheme — backbone compute/communication shape is unchanged.
"""
from .base import ModelConfig, dense_layout, register


def full() -> ModelConfig:
    return ModelConfig(
        name="musicgen-large", family="audio",
        n_layers=48, d_model=2048, n_heads=32, n_kv_heads=32,
        d_ff=8192, vocab_size=2048, norm="layernorm",
        input_mode="audio_codes", n_codebooks=4,
        layout=dense_layout(48), scan_period=1,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="musicgen-large-smoke", family="audio",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=128, vocab_size=64, norm="layernorm",
        input_mode="audio_codes", n_codebooks=4,
        layout=dense_layout(2), scan_period=1,
    )


register("musicgen-large", full, smoke)
