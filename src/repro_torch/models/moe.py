"""Token-choice MoE: the parameter schema only.

The port knows the MoE layer's parameters, so ``count_params`` agrees with
the reference for every architecture, but it does not run the layer yet:
building a model with an ``ffn == "moe"`` layer raises
``NotImplementedError`` (ROADMAP Queue 1 item 5, ``models/moe.py``).
"""

from __future__ import annotations

from typing import Dict

from ..configs.base import ModelConfig
from .layers import ParamDef

NOT_PORTED = ("MoE layers are not ported yet (ROADMAP Queue 1 item 5: "
              "models/moe.py)")


def moe_schema(cfg: ModelConfig) -> Dict[str, ParamDef]:
    d, fe, e = cfg.d_model, cfg.moe_d_ff, cfg.n_experts
    wscale = 0.02 / (2 * cfg.n_layers) ** 0.5
    s = {
        "router": ParamDef((d, e), ("embed", None)),
        "wg": ParamDef((e, d, fe), ("experts", "expert_in", "expert_ff")),
        "wu": ParamDef((e, d, fe), ("experts", "expert_in", "expert_ff")),
        "wd": ParamDef((e, fe, d), ("experts", "expert_ff", "expert_in"),
                       ("normal", wscale)),
    }
    if cfg.n_shared_experts:
        fs = cfg.moe_d_ff * cfg.n_shared_experts
        s["shared_wg"] = ParamDef((d, fs), ("embed", "ff"))
        s["shared_wu"] = ParamDef((d, fs), ("embed", "ff"))
        s["shared_wd"] = ParamDef((fs, d), ("ff", "embed"), ("normal", wscale))
    return s
