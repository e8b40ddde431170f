"""Pretrained inference interfaces of the port and artifact fetching (the
names of ``svt_speechbrain_tpu.pretrained``), imported on first use so
that ``pretrained.fetching`` imports without the interfaces' models."""

_WHERE = {"fetch": "fetching", "Pretrained": "interfaces",
          "SingingTranscriber": "interfaces", "EncoderClassifier":
          "interfaces", "SpeakerRecognition": "interfaces",
          "SepformerSeparation": "interfaces",
          "SpectralMaskEnhancement": "interfaces",
          "EncoderASR": "interfaces", "EncoderDecoderASR": "interfaces",
          "VAD": "interfaces"}
__all__ = sorted(_WHERE)


def __getattr__(name):
    if name not in _WHERE:
        raise AttributeError(name)
    import importlib

    module = importlib.import_module(f"{__name__}.{_WHERE[name]}")
    return getattr(module, name)
