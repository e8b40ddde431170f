"""The SSL families' new shapes and routes through the port's CUDA kernels,
on the card: the frontend kernel without conv biases (data2vec-audio,
WavLM), the short attention kernel at 12 heads (the base models), a
training step under ``remat`` against the same step without it, and the
int8 kernel at wav2vec2-base's 768-wide products.

Card-only: every test carries the ``cuda`` marker and skips without a CUDA
device. The file imports torch and the port only (no JAX):

    python -m pytest --noconftest -q tests/test_torch_families_card.py
"""
import dataclasses

import numpy as np
import pytest
import torch

import chip_smoke
from svt_speechbrain_tpu_torch import ops
from svt_speechbrain_tpu_torch.convert_jax import (init_linear, init_wav2vec2,
                                                   load_module_tree)
from svt_speechbrain_tpu_torch.core import Stage
from svt_speechbrain_tpu_torch.models.wav2vec2 import (ConvFeatureExtractor,
                                                       HuggingFaceWav2Vec2,
                                                       Wav2Vec2Config)
from svt_speechbrain_tpu_torch.nnet.linear import Linear
from svt_speechbrain_tpu_torch.ops import conv_frontend as cf
from svt_speechbrain_tpu_torch.ops import flash_attention as fa
from svt_speechbrain_tpu_torch.tasks.amt import AudioAMT

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("make", ["data2vec_audio_large", "wavlm_large"])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-3),
                                       (torch.bfloat16, 6.25e-2)])
def test_frontend_kernel_without_conv_bias(cuda_device, make, dtype, tol):
    """Row 1 of a family without conv biases: the zeros packed in their
    place, 7 launches, against the plain version (chip_smoke's
    tolerances)."""
    cfg = getattr(Wav2Vec2Config, make)()
    assert not cfg.conv_bias and cf.can_fuse(cfg, torch.zeros(1, 16123))
    tree = init_wav2vec2(cfg, torch.Generator().manual_seed(0))
    holder = torch.nn.Module()
    holder.feature_extractor = ConvFeatureExtractor(cfg)
    load_module_tree(holder, {"feature_extractor":
                              tree["encoder"]["feature_extractor"]})
    ext = holder.feature_extractor.to(cuda_device)
    assert ext.layers[0].conv.bias is None
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    wav = torch.randn(2, 16123, generator=gen, device=cuda_device).to(dtype)
    packed = ext.packed(dtype)
    before = cf.fused_conv_frontend.launches
    got = cf.fused_conv_frontend(wav, packed)
    torch.cuda.synchronize()
    assert cf.fused_conv_frontend.launches == before + 7
    want = cf.conv_frontend_reference(wav, packed)
    assert (got.float() - want.float()).abs().max().item() <= tol
    plain = ext(wav.float(), fused=False)
    assert (got.float() - plain).abs().max().item() <= max(tol, 1e-3)


def test_group_mode_never_takes_the_frontend_kernel(cuda_device):
    cfg = Wav2Vec2Config.base()
    assert not cf.can_fuse(cfg, torch.zeros(1, 16123, device=cuda_device))
    ext = ConvFeatureExtractor(cfg).to(cuda_device)
    before = cf.fused_conv_frontend.launches
    ext(torch.zeros(1, 16123, device=cuda_device))
    assert cf.fused_conv_frontend.launches == before


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
def test_short_attention_at_12_heads(cuda_device, dtype, tol):
    """Row 2 at the base models' (8, 12, 249, 64), ragged lengths with an
    empty row, against the plain version."""
    gen = torch.Generator(device=cuda_device).manual_seed(2)
    q, k, v, lens = chip_smoke.attention_inputs(
        (8, 12, 249, 64), chip_smoke.SHORT_LENGTHS, dtype, gen)
    before = fa.flash_attention_short.launches
    got = fa.flash_attention_short(q, k, v, lens)
    torch.cuda.synchronize()
    assert fa.flash_attention_short.launches == before + 1
    want = fa.attention_reference(q, k, v, lens)
    assert (got.float() - want.float()).abs().max().item() <= tol
    assert (got[lens == 0] == 0).all()


def _step(cuda_device, remat, remat_frontend):
    """One f32 full-finetune step of 2 data2vec-audio-large layers at full
    width, batch 2 x 25 s (1249 frames: the streaming kernels under
    dropout), every dropout 0.1: loss, clipped gradients, launches."""
    cfg = dataclasses.replace(Wav2Vec2Config.data2vec_audio_large(),
                              num_layers=2, remat=remat,
                              remat_frontend=remat_frontend)
    gen = torch.Generator().manual_seed(3)
    bridge = HuggingFaceWav2Vec2(config=cfg)
    head = Linear(20, cfg.hidden_size)
    load_module_tree(bridge, init_wav2vec2(cfg, gen))
    load_module_tree(head, init_linear(gen, cfg.hidden_size, 20))
    brain = AudioAMT({"wav2vec2": bridge, "model": head},
                     hparams=chip_smoke.amt_hparams(),
                     run_opts={"device": str(cuda_device)})
    brain.init_optimizers()
    brain.on_stage_start(Stage.TRAIN, 3)
    batch = chip_smoke.train_batch(np.random.default_rng(4), 2, 25.0)
    ops.reset_launch_counts()
    loss = brain.fit_batch(batch)
    counts = ops.launch_counts()
    grads = {n: p.grad.clone() for n, p in brain.modules.named_parameters()}
    return loss, grads, counts


def test_remat_step_matches_the_step_without_remat(cuda_device):
    """Loss and every clipped gradient within chip_smoke's card step
    tolerances; ``remat`` doubles the training forward's launches."""
    loss, grads, counts = _step(cuda_device, False, False)
    assert counts["flash_attention_lse"] == 2
    for remat_frontend in (False, True):
        got_loss, got, got_counts = _step(cuda_device, True, remat_frontend)
        assert got_counts["flash_attention_lse"] == 4
        assert got_counts["flash_attention_bwd_dq"] == 2
        assert abs(got_loss / loss - 1) <= chip_smoke.TOL_STEP["loss_rel"]
        for name, g in grads.items():
            ref = torch.linalg.vector_norm(g)
            if ref > 0:
                err = torch.linalg.vector_norm(got[name] - g) / ref
                assert err <= chip_smoke.TOL_STEP["grad_rel"], name


@pytest.mark.parametrize("m,k,n", chip_smoke.BASE_INT8_SHAPES)
@pytest.mark.parametrize("tag", ["f32", "bf16"])
def test_int8_kernel_at_768(cuda_device, m, k, n, tag):
    """Row 5 at int8 wav2vec2-base's feat_proj, ffn1 and ffn2: integers and
    scales bit for bit, the output within chip_smoke's tolerance."""
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    chip_smoke.hold_int8(m, k, n, tag, chip_smoke.DTYPES[tag], gen)
