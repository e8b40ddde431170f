"""The conformer ASR path on the card: the assembly of ``chip_smoke.py``'s
phase 23 at 2 encoder and 1 decoder layers (every width as in the phase),
dropout 0, no augmentation, on the card against the same modules on the
CPU: the eval log-probabilities, one training forward's loss and the
BatchNorm statistics after it, every parameter's gradient in f64, the f32
gradients against f64; the beam search card against CPU; and each
augmenter's apply card against CPU on the same draws.

Card-only: every test carries the ``cuda`` marker and skips without a CUDA
device. The file imports torch and the port only (no JAX):

    python -m pytest --noconftest -q tests/test_torch_conformer_card.py

Tolerances (TF32 off) are ``chip_smoke.py``'s ``TOL_CONFORMER``,
``TOL_DECODE_SCORE`` and ``TOL_AUGMENT``, whose comments give their
reasons.
"""
import copy

import numpy as np
import pytest
import torch

import chip_smoke as cs
from svt_speechbrain_tpu_torch.convert_jax import init_modules
from svt_speechbrain_tpu_torch.core import Stage

pytestmark = pytest.mark.cuda

ARCH = dict(cs.CONFORMER_ARCH, num_encoder_layers=2, num_decoder_layers=1,
            dropout=0.0)
SECONDS = (3.0, 2.0)


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


def test_conformer_assembly_card_matches_cpu(cuda_device):
    modules = cs.conformer_modules(ARCH, augment=False)
    init_modules(modules, 7)
    batch = cs.conformer_batch(np.random.default_rng(0), SECONDS)
    out = {f"{dev}_{str(dt)[-2:]}": cs.conformer_step(
        copy.deepcopy(modules), batch, dev, dt)
        for dev in ("cuda", "cpu") for dt in (torch.float32, torch.float64)}
    t = cs.TOL_CONFORMER
    got, want = out["cuda_32"], out["cpu_32"]
    for g, w in zip(got["out"], want["out"]):
        assert (g - w).abs().max().item() <= t["logp_abs"]
    assert abs(got["loss"] / want["loss"] - 1) <= t["loss_rel"]
    for name, w in want["stats"].items():
        assert _rel(got["stats"][name], w) <= t["stats_rel"], name
    f64, _ = cs.leaf_errors(out["cuda_64"], out["cpu_64"],
                            {"grad_rel": "grads"})
    assert max(f64["grad_rel"].values()) <= t["grad_f64_rel"]
    errs = cs.leaf_errors(out["cuda_32"], out["cuda_64"],
                          {"grad_rel": "grads"})[0]["grad_rel"]
    for name, err in errs.items():
        tol = (t["grad_f32_heads"] if name.startswith(cs.CONFORMER_HEADS)
               else t["grad_f32_normed"])
        assert err <= tol, (name, err)


def test_conformer_beam_search_card_matches_cpu(cuda_device):
    modules = cs.conformer_modules(ARCH, augment=False)
    init_modules(modules, 8)
    batch = cs.conformer_batch(np.random.default_rng(1), SECONDS)
    results = {}
    for dev in ("cuda", "cpu"):
        brain = cs.conformer_brain(copy.deepcopy(modules), dev, 0)
        arrays = brain._batch_to_device(batch)
        with torch.inference_mode():
            enc, _ = brain.modules.asr.encode(
                brain.features(arrays, Stage.VALID), arrays["sig"].lengths)
        results[dev] = cs.conformer_searcher(brain.modules, 5, enc.shape[1],
                                             beam=3)(enc,
                                                     arrays["sig"].lengths)
    cs.same_searches(results["cuda"], results["cpu"], "beam search")


def test_augmenters_card_match_cpu(cuda_device):
    gen = torch.Generator(device="cuda").manual_seed(3)
    wav = 0.1 * torch.randn(2, 16000, generator=gen, device="cuda")
    lens = torch.tensor([1.0, 0.7], device="cuda")
    errs = cs.augmenters_card_vs_cpu(gen, wav, lens)
    assert max(errs.values()) <= cs.TOL_AUGMENT
