"""The frozen counts against hand-worked figures, and against the port's
cost model at the shapes where the benchmark froze them."""

from __future__ import annotations

import math

import pytest

from bench import costs, harness
from bench.ref import model as ref_model

INTERNLM2 = harness.read_json(harness.ROOT / "bench" / "configs"
                              / "internlm2-1.8b.json")
FALCON = harness.read_json(harness.ROOT / "bench" / "configs"
                           / "falcon-mamba-7b.json")


def test_causal_pairs_by_hand():
    assert costs.causal_pairs(4, 4) == 1 + 2 + 3 + 4
    assert costs.causal_pairs(2, 8, q_offset=5) == 6 + 7
    assert costs.causal_pairs(3, 4, q_offset=2) == 3 + 4 + 4
    assert costs.causal_pairs(4096, 4096) == 4096 * 4097 // 2


def test_attention_by_hand():
    # B 4 x S 4,096, 16 heads of 128: 4 x 128 x 8,390,656 pairs x 64
    assert costs.attn_flops(4, 4096, 4096, 16, 128) == 274_945_015_808
    # bf16 q, o (4 x 4,096 x 16 x 128) and k, v (8 kv heads), f32 lse
    assert costs.attn_bytes(4, 4096, 4096, 16, 8, 128, 2) == \
        2 * (2 * 33_554_432 + 2 * 16_777_216) + 4 * 262_144
    assert costs.attn_least_s(4, 4096, 4096, 16, 8, 128, 2) == \
        pytest.approx(274_945_015_808 / 989e12)


def test_scan_by_hand():
    # falcon-mamba-7b's launch at B 4 x S 4,096: the exponentials bind
    exps = 4 * 4096 * 8192 * 16
    assert costs.scan_least_s(4, 4096, 8192, 16, 2) == pytest.approx(
        exps / (132 * 16 * 1.98e9))


def test_models_by_hand():
    # internlm2-1.8b: 24 x (attention 12,582,912 + MLP 50,331,648) + the
    # unembedding 2,048 x 92,544
    assert costs.matmul_weights(INTERNLM2) == 24 * 62_914_560 + 189_530_112
    # falcon-mamba-7b at 8 layers: 8 x (in 67,108,864 + x 2,359,296 + dt
    # 2,097,152 + out 33,554,432) + the unembedding 4,096 x 65,024
    assert costs.matmul_weights(FALCON) == 8 * 105_119_744 + 266_338_304
    assert costs.train_step_flops(FALCON, 4, 4096) == \
        6.0 * (8 * 105_119_744 + 266_338_304) * 16_384
    assert costs.train_step_flops(INTERNLM2, 4, 4096) == \
        6.0 * 1_699_479_552 * 16_384 + 3.0 * 24 * 274_945_015_808


def test_frozen_copies_equal_the_ports_cost_model():
    from repro_torch import roofline

    for args in [(4, 4096, 4096, 16, 8, 128, 2),
                 (4, 32768, 32768, 16, 8, 128, 2)]:
        ms, _ = roofline.attn_bound(*args)
        assert costs.attn_least_s(*args) * 1e3 == pytest.approx(ms)
    ms, _ = roofline.scan_bound(4, 4096, 8192, 16, 2)
    assert costs.scan_least_s(4, 4096, 8192, 16, 2) * 1e3 == \
        pytest.approx(ms)


def test_the_configurations_as_the_port_counts_them():
    from repro_torch.configs import get_config
    from repro_torch.models import count_params

    assert count_params(harness.program_config(INTERNLM2)) == 1_889_110_016
    assert count_params(harness.program_config(FALCON)) == 1_375_178_752
    for cfg in (INTERNLM2, FALCON):
        assert sum(math.prod(s) for _, s, _ in ref_model.schema(cfg)) == \
            count_params(harness.program_config(cfg))
    assert get_config("falcon-mamba-7b").n_layers == 64
