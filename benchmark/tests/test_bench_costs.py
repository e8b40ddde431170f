"""``costs.py`` against counts worked out by hand."""
from __future__ import annotations

import json
from pathlib import Path

import pytest

from benchmark import costs

HERE = Path(costs.__file__).resolve().parent
LV60 = json.loads((HERE / "configs" / "lv60-amt.json").read_text())
D2V = json.loads((HERE / "configs" / "d2v-audio-large-amt.json").read_text())


def test_frames_of_a_5s_chunk():
    # 80000 → 15999 → 7999 → 3999 → 1999 → 999 → 499 → 249
    assert costs.output_frames(LV60, 80000) == 249
    assert costs.output_frames(LV60, 480000) == 1499


@pytest.mark.parametrize("cfg,per_frame", [
    # lv60: one grouped conv, 64 inputs a group, 128 taps, 1024 outputs
    (LV60, 2 * 64 * 128 * 1024),
    # data2vec: five grouped convs, 64 inputs a group, 19 taps each
    (D2V, 5 * 2 * 64 * 19 * 1024),
])
def test_positional_conv(cfg, per_frame):
    assert costs.pos_conv_flops(cfg, 249) == per_frame * 249


def test_lv60_forward_by_hand():
    t, d, f = 249, 1024, 4096
    frontend = 2 * 10 * 512 * 15999 + sum(
        2 * 512 * k * 512 * n for k, n in zip(
            (3, 3, 3, 3, 2, 2), (7999, 3999, 1999, 999, 499, 249)))
    layer = 8 * t * d * d + 4 * t * t * d + 4 * t * d * f
    want = (frontend + 2 * t * 512 * d + 2 * 64 * 128 * d * t + 24 * layer
            + 2 * t * d * 20)
    assert costs.amt_forward_flops(LV60, 80000) == pytest.approx(want, rel=1e-12)
    assert costs.amt_train_flops(LV60, 80000) == pytest.approx(3 * want,
                                                              rel=1e-12)
    # about 186 GFLOP a 5 s chunk (PERF.md)
    assert 180e9 < want < 190e9


def test_d2v_differs_from_lv60_by_its_positional_convs():
    diff = (costs.amt_forward_flops(D2V, 80000)
            - costs.amt_forward_flops(LV60, 80000))
    assert diff == pytest.approx((5 * 19 - 128) * 2 * 64 * 1024 * 249,
                                 rel=1e-12)


def test_frontend_cost_by_hand():
    flops, nbytes = costs.frontend_cost(LV60, 32, 80000, 2)
    assert flops == 32 * (2 * 10 * 512 * 15999 + sum(
        2 * 512 * k * 512 * n for k, n in zip(
            (3, 3, 3, 3, 2, 2), (7999, 3999, 1999, 999, 499, 249))))
    weights = 10 * 512 + 512 * 512 * (3 * 4 + 2 * 2)
    assert nbytes == (32 * 80000 + weights + 32 * 249 * 512) * 2 \
        + 3 * 7 * 512 * 4
    _, d2v_bytes = costs.frontend_cost(D2V, 32, 80000, 2)
    assert nbytes - d2v_bytes == 7 * 512 * 4      # no conv bias


def test_attention_costs_by_hand():
    flops, nbytes = costs.attention_cost((2, 16, 249, 64), [249, 100], 2)
    assert flops == 4 * 16 * 249 * (249 + 100) * 64
    assert nbytes == 16 * 64 * (249 * 2 + 2 * 349 + 249 * 2) * 2 + 8
    shape = (8, 16, 1499, 64)
    tile, rows = 8 * 16 * 1499 * 64 * 4, 8 * 16 * 1499 * 4
    assert costs.training_cost("flash_attention_bwd_dkv", shape, 4) == (
        8 * 8 * 16 * 1499 * 1499 * 64, 6 * tile + 2 * rows)


def test_peaks_have_no_override(monkeypatch):
    monkeypatch.setenv("SVT_PEAK_TFLOPS", "1")
    assert costs.PEAK_FLOPS == {"bf16": 989e12, "f32": 165e12}
    assert costs.bound(165e12, 0, costs.PEAK_FLOPS["f32"]) == 1.0
    assert costs.bound(0, 3.35e12, 1.0) == 1.0
