"""svt_speechbrain_tpu_torch — the PyTorch/CUDA port of ``svt_speechbrain_tpu``.

The port mirrors the JAX package module for module (same names, same
channel-last layouts at module boundaries), written as ``torch.nn.Module``s
and plain tensor functions. Every Pallas kernel on the ported path is a
hand-written Hopper (``sm_90a``) CUDA kernel under ``csrc/``, built with
``nvcc`` at first use and bound with ``ctypes`` (``ops/_build.py``).

- ``nnet``      — Linear, activations, normalization, Conv1d, attention,
  losses, schedulers, the transducer pieces.
- ``ops``       — the CUDA kernel wrappers and their plain PyTorch versions.
- ``models``    — wav2vec2-large-lv60 ("layer" extractor, pre-LN encoder),
  the RCA fusion network, int8 quantization.
- ``processing`` — signal processing (SNR mixing for the noisy sets),
  features, augmentation, multi-mic beamforming and localization, NMF,
  PLDA/LDA and diarization.
- ``alignment``, ``lm``, ``tokenizers`` — HMM forced alignment and CTC
  segmentation, back-off n-gram LMs, SentencePiece tokenizers.
- ``core``      — the engine: ``Brain`` (``fit``, ``evaluate``), the
  command line and the experiment folder; ``config`` reads its yaml.
- ``dataio``    — CSV datasets, WAV I/O, padded batches, samplers, loaders.
- ``tasks``     — the AMT brains; ``recipes`` — the MIR-ST500 recipe and
  the N20EMv2 audio-only and audio-visual (fusion) recipes.
- ``utils``     — checkpoints, epoch counter, train logger, metric stats,
  and the AMT frame/note decode library (numpy).
- ``inference`` — ``BatchedAMTTranscriber``, chunked batched serving.
- ``flagship``  — the flagship AMT forward (wav2vec2 + 20-logit head).
- ``convert_jax`` — JAX parameter trees → the port's modules, and seeded
  random trees of the same shapes.

Importing this package imports torch and numpy only; the yaml loader
imports PyYAML when it reads a file.
"""
from __future__ import annotations

__version__ = "0.1.0"


def resolve_device(device=None):
    """The device an entry point runs on: ``cuda`` unless the caller names
    another one. Without CUDA and without an explicit device this raises —
    an entry point never continues on the CPU unless asked to.

    Example
    -------
    >>> resolve_device("cpu")
    device(type='cpu')
    """
    import torch

    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port's plain PyTorch path on the CPU")
    return torch.device("cuda")
