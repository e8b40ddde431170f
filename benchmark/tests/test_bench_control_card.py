"""The controls, on the card at the cells' own sizes: what the next lower
precision than the configuration states gives must come out not correct.

- Serving (bf16): the reference with every product's operands in float8
  e4m3, put in the program's place for the requests a run checks, after a
  short window at the cell's load. The program's own int8 path
  (``quantize="int8"``) reads as the bf16 program does (``PERF.md``), so
  it cannot serve as the control; its readings are printed beside.
- Training (f32, TF32 off): the reference put in the program's place with
  TF32 on, over the same batches and steps as a run's set-up.

Run on a machine with the card:
``python -m pytest benchmark/tests/test_bench_control_card.py -m cuda``.
``BENCH_CONTROL_SEEDS`` (comma-separated) picks the seeds.
"""
from __future__ import annotations

import os

import pytest
import torch

from benchmark import run, weights
from benchmark.reference import train as ref_train

SEEDS = [int(s) for s in os.environ.get(
    "BENCH_CONTROL_SEEDS", "2147483731,2147483757,2147483789").split(",")]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


def serve_control(cell, seed, seconds=8.0):
    """(correct, checks) of the fp8 control over a run's requests."""
    _, _, c = run.run_cell(cell, seed, seconds, 0)
    c.use_control()
    checks = c.check()
    return all(v <= lim for _, v, lim in checks), checks


def int8_readings(cell, seed, seconds=8.0):
    return run.run_cell(cell, seed, seconds, 0, overrides={
        "traffic": {"quantize": "int8"}})[1]


def train_control(cell, seed):
    """The readings of the TF32 reference in the program's place, checked
    as a run checks the program's."""
    _, cfg, traffic = run.cell_spec(cell)
    driver = run.load_module("drivers", traffic["driver"])
    limits = run.load_json("workloads", f"{cell}.json")["limits"]
    c = driver.Cell(cfg, dict(traffic, checked_steps=3), seed, "cuda", limits)
    c.release()
    batches = [(w.cuda(), a.cuda(), r.cuda()) for w, _, a, r in
               (c.rebuild(got[0]) for got in c.checked_batches)]
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        c.losses, c.first_grads, c.change = ref_train.train_steps(
            cfg, weights.make_weights(cfg, seed, "cuda"), batches, seed,
            traffic["lr_wav2vec"], traffic["lr"])
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    torch.cuda.empty_cache()
    checks = c.check()
    return all(v <= lim for _, v, lim in checks), checks


@pytest.mark.cuda
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("cell", ["lv60-serve-songs", "d2v-serve-songs"])
def test_serving_control_is_not_correct(card, cell, seed):
    correct, checks = serve_control(cell, seed)
    print(cell, seed, "fp8", checks)
    print(cell, seed, "int8", int8_readings(cell, seed))
    assert correct is False


@pytest.mark.cuda
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("cell", ["lv60-train-5s"])
def test_training_control_is_not_correct(card, cell, seed):
    correct, checks = train_control(cell, seed)
    print(cell, seed, checks)
    assert correct is False


@pytest.mark.cuda
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("cell", ["lv60-train-5s"])
def test_training_half_batch_fault_at_full_size(card, cell, seed):
    """The half-batch fault (``test_bench_faults.HalfRows``) read at the
    cell's own size: its readings must stay above the control's, which
    set the upper readings."""
    from benchmark.tests.test_bench_faults import HalfRows

    result, checks, _ = run.run_cell(cell, seed, 4.0, 0, cell_class=HalfRows)
    print(cell, seed, "half batch", checks)
    assert result["correct"] is False
