"""The reference against the port's CPU path at test size: serving in f32
(both positional-conv kinds), training with dropout replayed on the eager
path (short rows) and on the hash path (rows of 1024 frames or more)."""
from __future__ import annotations

import pytest

from benchmark import run
from benchmark.tests import tiny


@pytest.mark.parametrize("cell", ["lv60-serve-songs", "d2v-serve-songs"])
def test_serving_matches_the_port(cell):
    result, checks, c = tiny.run_tiny(cell)
    got = {name: value for name, value, _ in checks}
    assert got["onset_offset_prob_gap"] < 1e-5
    assert got["octave_logit_gap"] == got["pitch_class_logit_gap"] == 0.0
    assert got["songs_with_other_notes"] == 0.0
    assert result["attempted"] >= 2
    compared, frames = c.compared
    assert compared >= 2 and frames > 100


def test_the_fp8_control_reads_far_above_the_port():
    _, checks, cell = tiny.run_tiny("lv60-serve-songs")
    program = dict((n, v) for n, v, _ in checks)
    cell.use_control()
    control = dict((n, v) for n, v, _ in cell.check())
    assert control["onset_offset_prob_gap"] > 100 * program[
        "onset_offset_prob_gap"]


@pytest.mark.parametrize("cell,traffic", [
    ("lv60-train-5s", tiny.TRAIN), ("lv60-train-5s", None),
    ("lv60-train-5s", tiny.TRAIN_LONG)], ids=["buckets", "5s", "hash"])
def test_training_matches_the_port(cell, traffic):
    _, checks, c = tiny.run_tiny(cell, traffic=traffic)
    got = {name: value for name, value, _ in checks}
    assert got["loader_rows_other"] == 0.0
    assert got["loss_gap"] < 1e-6
    assert got["first_grad_leaf_gap"] < 1e-5
    assert got["change_leaf_gap"] < 1e-3
    layers = run.cell_spec(cell, tiny.overrides(cell, traffic))[1][
        "num_hidden_layers"]
    # the key biases, whose gradient is nought under softmax
    assert c.left_out == [f"wav2vec2.encoder.layers.{i}.attn.bk"
                          for i in range(layers)]
