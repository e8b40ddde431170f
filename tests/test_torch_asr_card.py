"""AV-HuBERT seq2seq ASR on the card: a TINY ``AVHubertASR`` (one encoder
layer 64 wide with one head of 64, one decoder layer) on the card against
the same model on the CPU, and the three decode routes against each other
on the card.

Card-only: every test carries the ``cuda`` marker and skips without a CUDA
device. The file imports torch and the port only (no JAX):

    python -m pytest --noconftest -q tests/test_torch_asr_card.py

Tolerances: tokens exact; scores within SCORE_ATOL between the card and
the CPU (f32 sums in other orders), within ROUTE_ATOL between the routes on
one card (the same kernels on the same inputs).
"""
import copy

import numpy as np
import pytest
import torch

from svt_speechbrain_tpu_torch import ops
from svt_speechbrain_tpu_torch.convert_jax import init_modules
from svt_speechbrain_tpu_torch.decoders import FairseqSequenceGenerator
from svt_speechbrain_tpu_torch.models.avhubert import AVHubertConfig
from svt_speechbrain_tpu_torch.models.avhubert_asr import AVHubertASR
from svt_speechbrain_tpu_torch.models.seq2seq_decoder import (
    FairseqDecoderConfig)

pytestmark = pytest.mark.cuda

SCORE_ATOL = 1e-4
ROUTE_ATOL = 1e-5


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _tiny(seed):
    asr = AVHubertASR(
        AVHubertConfig(encoder_layers=1, encoder_embed_dim=64,
                       encoder_ffn_embed_dim=128, encoder_attention_heads=1,
                       audio_feat_dim=8),
        FairseqDecoderConfig(vocab_size=40, embed_dim=64, ffn_dim=64,
                             num_layers=1, num_heads=2,
                             normalize_before=False, no_scale_embedding=True),
        beam_size=4, max_len_b=12)
    init_modules({"asr": asr}, seed=seed)
    return asr.eval()


def _inputs():
    rng = np.random.default_rng(0)
    audio = torch.from_numpy(rng.standard_normal((3, 20, 8))
                             .astype(np.float32))
    video = torch.from_numpy(rng.standard_normal((3, 20, 32, 32, 1))
                             .astype(np.float32))
    return audio, video


def _same(a, b, atol):
    assert len(a) == len(b)
    for ha, hb in zip(a, b):
        assert [h["tokens"].tolist() for h in ha] == \
            [h["tokens"].tolist() for h in hb]
        np.testing.assert_allclose([h["score"] for h in ha],
                                   [h["score"] for h in hb], rtol=0,
                                   atol=atol)


def test_tiny_asr_card_against_cpu(cuda_device):
    """Tokens equal; the encoder launches the short-attention kernel once a
    layer on the card (head dim 64) and the decoder none."""
    asr = _tiny(0)
    audio, video = _inputs()
    lengths = [20, 14, 20]
    cpu = asr.transcribe(audio=audio, video=video, frame_lengths=lengths)
    card = copy.deepcopy(asr).to(cuda_device)
    ops.reset_launch_counts()
    got = card.transcribe(audio=audio, video=video, frame_lengths=lengths)
    counts = ops.launch_counts()
    assert counts["flash_attention_short"] == 1
    assert sum(counts.values()) == 1
    _same(got, cpu, SCORE_ATOL)


def test_decode_routes_agree_on_the_card(cuda_device):
    asr = _tiny(1).to(cuda_device)
    audio, video = _inputs()
    enc = asr.encode(audio=audio, video=video)
    mask = torch.zeros(3, 20, dtype=torch.bool, device=cuda_device)
    mask[1, 15:] = True
    fast = asr.generator.generate(enc, mask)
    assert asr.generator.stats["host_reads"] == asr.generator.stats["steps"]
    device = asr.generator.generate_on_device(enc, mask)
    host = FairseqSequenceGenerator(
        asr.decoder, beam_size=4, max_len_b=12,
        lm=lambda t: torch.zeros(t.shape[0], 40, device=t.device)).generate(
            enc, mask)
    _same(device, fast, ROUTE_ATOL)
    _same(host, fast, ROUTE_ATOL)
