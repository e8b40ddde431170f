"""The CRDNN ASR path on the card: the assembly of ``chip_smoke.py``'s
phase 22 with 2 bidirectional LiGRU layers at TINY widths, dropouts 0, on
the card against the same modules on the CPU: the eval log-probabilities,
one training forward's loss and the running statistics after it, every
parameter's gradient (in f64); and the Brain's seeding on the card.

Card-only: every test carries the ``cuda`` marker and skips without a CUDA
device. The file imports torch and the port only (no JAX):

    python -m pytest --noconftest -q tests/test_torch_crdnn_card.py

Tolerances (TF32 off), as ``chip_smoke.py``'s ``TOL_CRDNN`` gives their
reasons: in f32, cuDNN's convolutions and the CPU's sum in other orders:
log-probabilities within LOGP_ATOL, the loss within LOSS_RTOL of itself,
the running statistics within STATS_RTOL. Every gradient is held in f64 on
both devices, within GRAD_F64_RTOL of each leaf's norm; in f32 against the
card's f64 step, the heads', embedding's and decoder's within
GRAD_F32_HEADS, the leaves behind a norm (sums that cancel) within
GRAD_F32_NORMED.
"""
import copy

import numpy as np
import pytest
import torch

import chip_smoke as cs
from svt_speechbrain_tpu_torch.convert_jax import init_modules, is_unseeded

pytestmark = pytest.mark.cuda

LOGP_ATOL = 1e-5
LOSS_RTOL = 1e-5
STATS_RTOL = 1e-5
GRAD_F64_RTOL = 1e-9
GRAD_F32_HEADS = 1e-4
GRAD_F32_NORMED = 1e-2
ARCH = dict(cs.CRDNN_ARCH, input_size=24, cnn_channels=(8, 16),
            rnn_layers=2, rnn_neurons=32, dnn_neurons=24, dropout=0.0)
DEC = dict(cs.CRDNN_DEC, hidden_size=16, attn_dim=12, kernel_size=10,
           dropout=0.0)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the card against the CPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _rel(a, b):
    return (torch.linalg.vector_norm(a - b)
            / torch.linalg.vector_norm(b)).item()


def test_crdnn_assembly_card_matches_cpu(cuda_device):
    modules = cs.crdnn_modules(ARCH, DEC, 13, 8)
    init_modules(modules, 5)
    batch = cs.crdnn_batch(np.random.default_rng(0), (1.2, 0.9, 0.6), 13)
    out = {(dev, dt): cs.brain_step(cs.crdnn_brain, copy.deepcopy(modules),
                                    batch, dev, dtype, state=cs.crdnn_state)
           for dev in ("cuda", "cpu")
           for dt, dtype in (("f32", torch.float32), ("f64", torch.float64))}
    got, want = out["cuda", "f32"], out["cpu", "f32"]
    for g, w in zip(got["out"], want["out"]):
        assert (g - w).abs().max().item() <= LOGP_ATOL
    assert abs(got["loss"] / want["loss"] - 1) <= LOSS_RTOL
    for name, w in want["stats"].items():
        assert _rel(got["stats"][name], w) <= STATS_RTOL, name
    errs, _ = cs.leaf_errors(out["cuda", "f64"], out["cpu", "f64"],
                             {"grad_rel": "grads"})
    for name, err in errs["grad_rel"].items():
        assert err <= GRAD_F64_RTOL, (name, err)
    errs, _ = cs.leaf_errors(got, out["cuda", "f64"], {"grad_rel": "grads"})
    for name, err in errs["grad_rel"].items():
        tol = (GRAD_F32_HEADS if name.startswith(cs.CRDNN_HEADS)
               else GRAD_F32_NORMED)
        assert err <= tol, (name, err)


def test_brain_seeds_the_assembly_on_the_card(cuda_device):
    brain = cs.crdnn_brain(cs.crdnn_modules(ARCH, DEC, 13, 8), "cuda", 2)
    assert not any(is_unseeded(m) for m in brain.modules.values())
    assert all(p.device.type == "cuda" for p in brain.modules.parameters())
    batch = cs.crdnn_batch(np.random.default_rng(1), (1.0, 0.7), 13)
    assert np.isfinite(brain.fit_batch(batch))
