"""The separation, speaker and enhancement models on the card: the SepFormer
of ``chip_smoke.py``'s phase 24 at 1 dual block of 2 + 2 layers (width
256), ECAPA-TDNN at 128 channels with phase 25's 7205-way additive angular
margin head, and the MetricGAN+ ``SpectralMaskEnhancement`` interface at a
16-wide BLSTM, each on the card against the same modules on the CPU:
outputs and losses in f32, the running statistics after a training forward,
every gradient in f64. Every launch counter of ``csrc/`` stays at 0: no
kernel lies on this path.

Card-only: every test carries the ``cuda`` marker and skips without a CUDA
device. The file imports torch and the port only (no JAX):

    python -m pytest --noconftest -q tests/test_torch_separation_card.py

Tolerances (TF32 off) are ``chip_smoke.py``'s ``TOL_SEP`` and
``TOL_REST``, whose comments give their reasons.
"""
import copy

import numpy as np
import pytest
import torch

import chip_smoke as cs
from svt_speechbrain_tpu_torch import ops
from svt_speechbrain_tpu_torch.convert_jax import init_modules

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the card against the CPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ops.reset_launch_counts()
    yield torch.device("cuda")
    assert not any(ops.launch_counts().values()), ops.launch_counts()


def test_sepformer_card_matches_cpu(cuda_device):
    errs = cs.sepformer_card_vs_cpu(np.random.default_rng(0))
    assert errs["out_rel"] <= cs.TOL_SEP["out_rel"]
    assert errs["serve_rel"] <= cs.TOL_SEP["out_rel"]
    assert errs["grad_f64_rel"] <= cs.TOL_SEP["grad_f64_rel"]


def test_ecapa_aam_card_matches_cpu(cuda_device):
    errs = cs.ecapa_card_vs_cpu(np.random.default_rng(1))
    assert errs["grad_f64_rel"] <= cs.TOL_REST["grad_f64_rel"]
    assert errs["stats_rel"] <= cs.TOL_REST["stats_rel"]


def test_metricgan_interface_card_matches_cpu(cuda_device):
    modules = {"enhance_model": cs.EnhancementGenerator(257, 16, 2)}
    init_modules(modules, 3)
    noisy, _ = cs.speech_rows(np.random.default_rng(2), (1.0, 0.7))
    out = {}
    for dev in ("cuda", "cpu"):
        face = cs.SpectralMaskEnhancement(
            modules=copy.deepcopy(modules), hparams=cs.metricgan_hparams(),
            device=dev)
        out[dev] = face.enhance_batch(noisy).cpu()
    assert out["cuda"].shape == noisy.shape
    err = (out["cuda"] - out["cpu"]).abs().max().item()
    assert err <= cs.TOL_REST["out_rel"], err
