"""Pretrained inference interfaces (port of
``svt_speechbrain_tpu/pretrained/interfaces.py``): the ``Pretrained`` base
and ``SingingTranscriber``, the AMT flagship interface over the batched
chunked pipeline, its streaming session and its multiplexed server.

The modules of the port own their parameters, so an interface holds
modules only: ``init_params(seed)`` fills them with seeded draws, and
``convert_jax.load_jax_params`` or ``models.convert_hf.load_wav2vec2``
installs trained ones. ``from_hparams`` builds an interface from an
inference ``hyperparams.yaml`` (read by ``config``'s own reader) and the
files its ``pretrainer`` names (``torch.save`` state dicts or JAX msgpack
exports, fetched from a local directory).

``EncoderClassifier``, ``SpeakerRecognition``, ``SepformerSeparation`` and
``SpectralMaskEnhancement`` serve the speaker, separation and enhancement
models: each runs its modules (and the hparams' feature modules) on its
``device``, CUDA unless the caller names another, in eval and without
autograd, and keeps the JAX interface's host reads (the numpy score and
argmax of ``classify_batch``, the cosine of ``verify_batch``). The ASR
interfaces and ``VAD`` wait for ROADMAP.md queue 1 item 20.
"""
from __future__ import annotations

import functools
import os
import pathlib
from types import SimpleNamespace

import numpy as np
import torch

from svt_speechbrain_tpu_torch import resolve_device
from svt_speechbrain_tpu_torch.config import load_hyperyaml
from svt_speechbrain_tpu_torch.convert_jax import init_modules
from svt_speechbrain_tpu_torch.dataio.dataio import read_audio, write_audio
from svt_speechbrain_tpu_torch.inference import (BatchedAMTTranscriber,
                                                 StreamingAMTTranscriber,
                                                 StreamingServer)
from svt_speechbrain_tpu_torch.models.quantize import quantize_wav2vec2
from svt_speechbrain_tpu_torch.models.separation import separate
from svt_speechbrain_tpu_torch.pretrained.fetching import fetch


class Pretrained:
    """Base inference interface (``interfaces.py:20``). Subclasses declare
    ``HPARAMS_NEEDED``/``MODULES_NEEDED``; the hparams dict is exposed as a
    namespace, as in the Brain.

    Example
    -------
    >>> from svt_speechbrain_tpu_torch.nnet.linear import Linear
    >>> pt = Pretrained(modules={"head": Linear(4, 8)}, hparams={"foo": 1})
    >>> mods = pt.init_params()
    >>> sorted(vars(mods)), tuple(mods.head.w.shape), pt.hparams.foo
    (['head'], (8, 4), 1)
    >>> bool(mods.head.w.abs().sum() > 0)
    True
    """

    HPARAMS_NEEDED = []
    MODULES_NEEDED = []

    def __init__(self, modules=None, hparams=None):
        self.mods = SimpleNamespace(**(modules or {}))
        self.hparams = SimpleNamespace(**(hparams or {}))
        for name in self.HPARAMS_NEEDED:
            if not hasattr(self.hparams, name):
                raise ValueError(f"Need hparams['{name}']")
        for name in self.MODULES_NEEDED:
            if not hasattr(self.mods, name):
                raise ValueError(f"Need modules['{name}']")

    def init_params(self, seed=1234):
        """Fill every module with seeded random parameters (one
        ``torch.Generator``, modules in their given order); returns the
        modules' namespace."""
        init_modules(vars(self.mods), seed)
        return self.mods

    @classmethod
    def from_hparams(cls, source, hparams_file="hyperparams.yaml",
                     savedir=None, overrides=None, **kwargs):
        """An interface from ``source`` (a local directory;
        ``interfaces.py:64``): its ``hparams_file`` (with ``overrides``)
        builds the modules on the CPU, ``init_params`` fills them, the
        yaml's ``pretrainer`` collects its files into ``savedir`` (as
        SpeechBrain's ``from_hparams`` does; a file named without a
        directory is one of ``source``) and loads them, and the modules
        move to the interface's ``device`` where it has one. ``kwargs`` go
        to the interface (``device``, ``batch_size``, ``quantize``, ...). A
        URL or hub id raises: nothing is downloaded."""
        savedir = savedir or \
            f"./pretrained_models/{str(source).replace('/', '--')}"
        path = fetch(hparams_file, source, savedir)
        with open(path) as f:
            hparams = load_hyperyaml(f, overrides)
        instance = cls(modules=hparams.get("modules", {}), hparams=hparams,
                       **kwargs)
        instance.init_params()
        pretrainer = hparams.get("pretrainer")
        if pretrainer is not None:
            pretrainer.collect_in = pathlib.Path(savedir)
            pretrainer.collect_files(default_source=source)
            pretrainer.load_collected()
        device = getattr(instance, "device", None)
        for module in vars(instance.mods).values():
            if device is not None and isinstance(module, torch.nn.Module):
                module.to(device)
        return instance


class SingingTranscriber(Pretrained):
    """Whole-song AMT inference (the flagship deployment path): waveforms →
    note events, batched and chunked on the device (``interfaces.py:85``).

    Needs modules ``wav2vec2`` and ``model`` and the AMT decode hparams.
    ``chunking`` is "ceil" (throughput), "reference" (equal to the recipes'
    batch-1 eval) or "song" (whole-song attention windows; use a small
    ``batch_size``). ``quantize="int8"`` serves the encoder's FFN and
    feature-projection products in a8w8 (``models/quantize.py``); the float
    path is the default. ``device`` is CUDA unless the caller names another;
    ``compute_dtype`` (bf16 by default) is the serving copies' dtype.

    Example
    -------
    >>> import numpy as np
    >>> from svt_speechbrain_tpu_torch.flagship import build_modules
    >>> bridge, head = build_modules(tiny=True)
    >>> hp = {"frame_rate": 49.8, "onset_threshold": 0.4,
    ...       "offset_threshold": 0.5}
    >>> iface = SingingTranscriber(modules={"wav2vec2": bridge, "model": head},
    ...                            hparams=hp, batch_size=2, chunk_seconds=1.0,
    ...                            quantize="int8", device="cpu")
    >>> _ = iface.init_params()
    >>> notes = iface.transcribe_batch({"s": np.zeros(24000, np.float32)})
    >>> sorted(notes), all(len(ev) == 3 for ev in notes["s"])
    (['s'], True)
    """

    HPARAMS_NEEDED = ["frame_rate", "onset_threshold", "offset_threshold"]
    MODULES_NEEDED = ["wav2vec2", "model"]

    def __init__(self, *args, batch_size=32, chunk_seconds=5.0,
                 chunking="ceil", quantize=None, device=None,
                 compute_dtype=torch.bfloat16, **kwargs):
        super().__init__(*args, **kwargs)
        self.batch_size = batch_size
        self.chunk_seconds = chunk_seconds
        self.chunking = chunking
        if quantize not in (None, "int8"):
            raise ValueError(f"Unknown quantize mode: {quantize!r}")
        self.quantize = quantize
        self.compute_dtype = compute_dtype
        self.device = resolve_device(device)
        self._transcriber = None
        self._int8_w2v = None

    def _serving_bridge(self):
        """The bridge a new transcriber, stream or server is made from: the
        float one, or with ``quantize="int8"`` one int8 copy shared by all
        of them. Both are in full precision (the int8 copy is derived from
        the float weights, never from a bf16 cast), so a later
        ``compute_dtype`` acts on untruncated weights and scales; every
        transcriber casts its own copy."""
        if self.quantize != "int8":
            return self.mods.wav2vec2
        if self._int8_w2v is None:
            self._int8_w2v = quantize_wav2vec2(self.mods.wav2vec2)
        return self._int8_w2v

    def _decode_args(self):
        return dict(chunk_seconds=self.chunk_seconds,
                    frame_rate=self.hparams.frame_rate,
                    onset_threshold=self.hparams.onset_threshold,
                    offset_threshold=self.hparams.offset_threshold,
                    compute_dtype=self.compute_dtype, device=self.device)

    def _get_transcriber(self):
        if self._transcriber is None:
            self._transcriber = BatchedAMTTranscriber(
                self._serving_bridge(), self.mods.model,
                batch_size=self.batch_size, chunking=self.chunking,
                **self._decode_args())
        return self._transcriber

    def transcribe_file(self, path):
        """Audio file → [[onset_s, offset_s, midi], ...]
        (``interfaces.py:142``): the file read by ``dataio.read_audio``,
        transcribed as a batch of one song named by its basename."""
        name = os.path.basename(path)
        return self.transcribe_batch({name: read_audio(path)})[name]

    def transcribe_batch(self, songs):
        """dict name → waveform ⇒ dict name → note events."""
        return self._get_transcriber().transcribe(songs)

    def stream(self, **kwargs):
        """Open a low-latency streaming session on this interface's model
        and ``quantize`` mode (``inference.StreamingAMTTranscriber``):
        ``feed()`` PCM as it arrives, ``flush()`` at the end. Each call
        returns an independent session; extra keyword arguments
        (``compact``, ``compute_dtype``, ...) pass through."""
        return StreamingAMTTranscriber(
            self._serving_bridge(), self.mods.model,
            **{**self._decode_args(), **kwargs})

    def serve(self, batch_size=8, **kwargs):
        """Open a multiplexed streaming server on this interface's model
        and ``quantize`` mode (``inference.StreamingServer``): the ready
        windows of N concurrent ``server.open()`` sessions share one batch
        program."""
        return StreamingServer(
            self._serving_bridge(), self.mods.model, batch_size=batch_size,
            **{**self._decode_args(), **kwargs})


def _to_device(objects, device):
    """Move every ``nn.Module`` of ``objects`` (and those bound in a
    ``functools.partial``'s arguments) to ``device``."""
    for obj in objects:
        if isinstance(obj, torch.nn.Module):
            obj.to(device)
        elif isinstance(obj, functools.partial):
            _to_device(list(obj.args) + list(obj.keywords.values()), device)


class _DeviceInterface(Pretrained):
    """An interface whose modules run on its ``device`` (CUDA unless the
    caller names another)."""

    def __init__(self, *args, device=None, **kwargs):
        super().__init__(*args, **kwargs)
        self.device = resolve_device(device)
        _to_device(list(vars(self.mods).values())
                   + list(vars(self.hparams).values()), self.device)

    def _tensor(self, x):
        if isinstance(x, np.ndarray):
            x = np.ascontiguousarray(x)
        return None if x is None else torch.as_tensor(x, device=self.device)


class EncoderClassifier(_DeviceInterface):
    """Features → embedding → classifier (``interfaces.py:189``).
    ``encode_batch`` hands the relative ``wav_lens`` to the embedding
    model as they are; ``classify_batch`` returns (logits on the device,
    the numpy max score and argmax index of each row).

    Example
    -------
    >>> import numpy as np
    >>> from svt_speechbrain_tpu_torch.models.ecapa_tdnn import (
    ...     ECAPA_TDNN, Classifier)
    >>> from svt_speechbrain_tpu_torch.models.features import Fbank
    >>> clf = EncoderClassifier(modules={
    ...     "compute_features": Fbank(n_mels=24),
    ...     "embedding_model": ECAPA_TDNN(24, lin_neurons=16,
    ...         channels=(16, 16, 16, 16, 48), attention_channels=8,
    ...         res2net_scale=4, se_channels=8),
    ...     "classifier": Classifier(16, 16, 5)}, device="cpu")
    >>> _ = clf.init_params()
    >>> out, score, index = clf.classify_batch(np.zeros((2, 4000), np.float32))
    >>> tuple(out.shape), index.shape
    ((2, 1, 5), (2, 1))
    """

    MODULES_NEEDED = ["compute_features", "embedding_model", "classifier"]

    def encode_batch(self, wavs, wav_lens=None):
        with torch.no_grad():
            feats = self.mods.compute_features(self._tensor(wavs))
            return self.mods.embedding_model(feats,
                                             lengths=self._tensor(wav_lens))

    def classify_batch(self, wavs, wav_lens=None):
        emb = self.encode_batch(wavs, wav_lens)
        with torch.no_grad():
            out = self.mods.classifier(emb)
        host = out.cpu().numpy()
        return out, host.max(-1), host.argmax(-1)


class SpeakerRecognition(EncoderClassifier):
    """Speaker verification by the cosine of two embeddings
    (``interfaces.py:275``), computed on the host in numpy."""

    MODULES_NEEDED = ["compute_features", "embedding_model"]

    def verify_batch(self, wavs1, wavs2, wav_lens1=None, wav_lens2=None,
                     threshold=0.25):
        """(cosine scores, same-speaker decisions) of each row pair."""
        emb1 = self.encode_batch(wavs1, wav_lens1).cpu().numpy().reshape(
            len(wavs1), -1)
        emb2 = self.encode_batch(wavs2, wav_lens2).cpu().numpy().reshape(
            len(wavs2), -1)
        num = np.sum(emb1 * emb2, axis=-1)
        den = (np.linalg.norm(emb1, axis=-1) * np.linalg.norm(emb2, axis=-1)
               + 1e-12)
        score = num / den
        return score, score > threshold

    def verify_files(self, path_x, path_y, threshold=0.25):
        """(score, decision) of two audio files, read by ``dataio``."""
        x = np.asarray(read_audio(path_x))[None]
        y = np.asarray(read_audio(path_y))[None]
        score, decision = self.verify_batch(x, y, threshold=threshold)
        return float(score[0]), bool(decision[0])


class SepformerSeparation(_DeviceInterface):
    """Source separation (``interfaces.py:440``): encoder → mask network →
    a masked decode a source; the (B, T, sources) estimate is cut or
    zero-padded to the mixture's length. Any separator with the
    encoder/masknet/decoder split serves (SepFormer, Conv-TasNet's
    ``MaskNet``)."""

    MODULES_NEEDED = ["encoder", "masknet", "decoder"]

    def separate_batch(self, mix):
        with torch.no_grad():
            return separate(self.mods.encoder, self.mods.masknet,
                            self.mods.decoder, self._tensor(mix))

    def separate_file(self, path):
        """The separated sources of one audio file, read by ``dataio``."""
        return self.separate_batch(np.asarray(read_audio(path))[None])


class SpectralMaskEnhancement(_DeviceInterface):
    """Spectral-mask enhancement (``interfaces.py:472``): log1p magnitudes
    → the mask model → masked features → resynthesis with the noisy phase
    (the hparams' ``compute_stft``, ``spectral_magnitude`` and ``resynth``,
    moved to the device with the modules)."""

    HPARAMS_NEEDED = ["compute_stft", "spectral_magnitude", "resynth"]
    MODULES_NEEDED = ["enhance_model"]

    def compute_features(self, wavs):
        """log1p of the spectral magnitude of ``wavs``."""
        stft = self.hparams.compute_stft(self._tensor(wavs))
        return torch.log1p(self.hparams.spectral_magnitude(stft))

    def enhance_batch(self, noisy, lengths=None):
        noisy = self._tensor(noisy)
        with torch.no_grad():
            feats = self.compute_features(noisy)
            out = self.mods.enhance_model(feats,
                                          lengths=self._tensor(lengths))
            mask = out[0] if isinstance(out, tuple) else out
            return self.hparams.resynth(torch.expm1(mask * feats), noisy)

    def enhance_file(self, path, output_path=None):
        """Enhance one audio file read by ``dataio``; with ``output_path``
        also write it (at ``hparams.sample_rate``, 16 kHz without one)."""
        enhanced = self.enhance_batch(np.asarray(read_audio(path))[None])
        if output_path is not None:
            write_audio(output_path, enhanced[0].cpu().numpy(),
                        getattr(self.hparams, "sample_rate", 16000))
        return enhanced
