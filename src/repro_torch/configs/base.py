"""Model/config system: one dataclass covers all 10 assigned architectures.

The port's copy of the reference's config module (plain dataclasses, no
framework import); ``attention_impl`` names the implementation of both
sequence kernels (attention and the Mamba scan): ``"cuda"`` is the
hand-written kernel where the reference had ``"pallas"``.

A model is a heterogeneous stack of layers; each layer has a token *mixer*
("attn" | "mamba") and an *ffn* ("mlp" | "moe" | "none").  The stack is
expressed as ``prefix_layers`` unrolled layers followed by a repeating period
of ``scan_period`` layers scanned ``n_periods`` times (HLO stays O(period),
not O(depth) — required for 61-layer trillion-param dry-runs on one CPU).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    mixer: str          # "attn" | "mamba"
    ffn: str            # "mlp" | "moe" | "none"


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense | ssm | hybrid | vlm | audio | moe
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0               # 0 -> d_model // n_heads
    # --- attention ---
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    rope_pct: float = 1.0           # stablelm: partial rotary
    norm: str = "rmsnorm"           # "rmsnorm" | "layernorm"
    # --- embeddings / head ---
    tie_embeddings: bool = False
    # --- MoE ---
    n_experts: int = 0
    n_experts_active: int = 0
    moe_d_ff: int = 0
    n_shared_experts: int = 0
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    # --- Mamba (mamba-1) ---
    ssm_state: int = 16
    ssm_conv: int = 4
    ssm_expand: int = 2
    # --- stack layout ---
    layout: Tuple[LayerSpec, ...] = ()
    prefix_layers: int = 0          # leading unrolled layers
    scan_period: int = 1            # repeating period for the scanned tail
    # --- modality frontend (stubs per assignment) ---
    input_mode: str = "tokens"      # "tokens" | "vlm" | "audio_codes"
    vision_prefix: int = 256        # vlm: precomputed patch embeddings
    n_codebooks: int = 1            # musicgen: EnCodec codebooks
    # --- numerics / execution ---
    dtype: str = "bfloat16"         # activation/compute dtype
    param_dtype: str = "float32"
    remat_policy: str = "dots"      # "none" | "dots" | "full"
    attention_impl: str = "auto"    # "auto" | "naive" | "chunked" | "cuda"
    attn_chunk_q: int = 1024
    attn_chunk_kv: int = 1024
    attn_causal_skip: bool = False  # triangular block schedule (halves FLOPs)
    mamba_chunk: int = 256
    # --- sharding ---
    fsdp: bool = False              # also shard weight "other" axis over data
    expert_parallel: bool = True    # shard experts over model axis

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def n_periods(self) -> int:
        body = self.n_layers - self.prefix_layers
        assert body % self.scan_period == 0, (self.name, body, self.scan_period)
        return body // self.scan_period

    @property
    def dt_rank(self) -> int:
        return max(1, -(-self.d_model // 16))     # ceil(d_model/16), mamba-1

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    def layer_spec(self, i: int) -> LayerSpec:
        return self.layout[i]

    def period_layout(self) -> Tuple[LayerSpec, ...]:
        """The LayerSpecs of one scanned period (validated homogeneous)."""
        body = self.layout[self.prefix_layers:]
        period = body[: self.scan_period]
        for p in range(self.n_periods):
            chunk = body[p * self.scan_period:(p + 1) * self.scan_period]
            assert chunk == period, f"{self.name}: layout not periodic at {p}"
        return period

    def validate(self) -> "ModelConfig":
        assert len(self.layout) == self.n_layers, self.name
        assert self.n_heads % self.n_kv_heads == 0, self.name
        if any(l.ffn == "moe" for l in self.layout):
            assert self.n_experts > 0 and self.n_experts_active > 0
            assert self.moe_d_ff > 0
        self.period_layout()
        return self


# ---------------------------------------------------------------------------
# Layouts
# ---------------------------------------------------------------------------

def dense_layout(n: int) -> Tuple[LayerSpec, ...]:
    return tuple(LayerSpec("attn", "mlp") for _ in range(n))


def mamba_layout(n: int) -> Tuple[LayerSpec, ...]:
    return tuple(LayerSpec("mamba", "none") for _ in range(n))


def moe_layout(n: int) -> Tuple[LayerSpec, ...]:
    return tuple(LayerSpec("attn", "moe") for _ in range(n))


def jamba_layout(n: int, period: int = 8, attn_at: int = 4,
                 moe_every: int = 2) -> Tuple[LayerSpec, ...]:
    """Jamba: 1 attention per ``period`` layers (rest Mamba), MoE every
    ``moe_every``-th layer (odd positions), per arXiv:2403.19887."""
    out = []
    for i in range(n):
        mixer = "attn" if i % period == attn_at else "mamba"
        ffn = "moe" if i % moe_every == 1 else "mlp"
        out.append(LayerSpec(mixer, ffn))
    return tuple(out)


# ---------------------------------------------------------------------------
# Input shapes (the assignment's 4 shapes) + registry plumbing
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str            # "train" | "prefill" | "decode"


SHAPES: Dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}

#: archs allowed to run long_500k (sub-quadratic token mixing)
SUBQUADRATIC_FAMILIES = ("ssm", "hybrid")


def shape_applicable(cfg: ModelConfig, shape: InputShape) -> bool:
    if shape.name == "long_500k":
        return cfg.family in SUBQUADRATIC_FAMILIES
    return True


_REGISTRY: Dict[str, "tuple"] = {}


def register(arch_id: str, full, smoke) -> None:
    _REGISTRY[arch_id] = (full, smoke)


def get_config(arch_id: str, smoke: bool = False) -> ModelConfig:
    """Public entry: ``get_config("qwen2.5-14b")`` or the reduced smoke twin."""
    from . import _load_all   # populate registry lazily
    _load_all()
    if arch_id not in _REGISTRY:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(_REGISTRY)}")
    full, smoke_fn = _REGISTRY[arch_id]
    return (smoke_fn() if smoke else full()).validate()


def list_archs():
    from . import _load_all
    _load_all()
    return sorted(_REGISTRY)
