"""Pure-python reader/writer for SentencePiece's protobuf ``.model`` format.

Every published SpeechBrain/HF pretrained pipeline ships its tokenizer as a
``sentencepiece`` ModelProto protobuf (the native processor the reference
wraps, ``speechbrain/tokenizers/SentencePiece.py:20``, loads exactly these
files). The native lib is not in this image, so this module walks the proto
wire format directly — varints, 32-bit floats and length-delimited
submessages — for the ModelProto subset inference needs:

- ``pieces``   (field 1): repeated SentencePiece {piece=1: string,
  score=2: float, type=3: enum NORMAL=1/UNKNOWN=2/CONTROL=3/USER_DEFINED=4/
  UNUSED=5/BYTE=6}
- ``trainer_spec`` (field 2): model_type=3 (UNIGRAM=1/BPE=2/WORD=3/CHAR=4),
  vocab_size=4, split_by_whitespace=22, max_sentencepiece_length=20,
  unk_id=40, bos_id=41, eos_id=42, pad_id=43, unk_piece=45, bos_piece=46,
  eos_piece=47, pad_piece=48, unk_surface=44
- ``normalizer_spec`` (field 3): add_dummy_prefix=3, escape_whitespaces=5

The writer emits the same subset, so models trained by
:class:`~svt_speechbrain_tpu_torch.tokenizers.spm_lite.SentencePieceTrainer` are
loadable by the real ``sentencepiece`` library outside this image.

Example
-------
>>> raw = write_model(pieces=[("<unk>", 0.0, 2), ("▁a", -1.5, 1)],
...                   model_type="unigram", add_dummy_prefix=True)
>>> m = read_model(raw)
>>> m["pieces"]
[('<unk>', 0.0, 2), ('▁a', -1.5, 1)]
>>> m["model_type"], m["add_dummy_prefix"]
('unigram', True)

The port's copy of ``svt_speechbrain_tpu/tokenizers/spm_proto.py`` (pure Python), kept
identical but for its imports.
"""
from __future__ import annotations

import struct

MODEL_TYPES = {1: "unigram", 2: "bpe", 3: "word", 4: "char"}
MODEL_TYPE_IDS = {v: k for k, v in MODEL_TYPES.items()}
# SentencePiece.Type enum
NORMAL, UNKNOWN, CONTROL, USER_DEFINED, UNUSED, BYTE = 1, 2, 3, 4, 5, 6


# ---------------------------------------------------------------------------
# wire primitives
# ---------------------------------------------------------------------------

def _read_varint(data, pos):
    result, shift = 0, 0
    while True:
        b = data[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift > 63:
            raise ValueError("varint too long")


def _write_varint(value):
    if value < 0:  # negative int32/enum: 64-bit two's complement varint
        value += 1 << 64
    out = bytearray()
    while True:
        b = value & 0x7F
        value >>= 7
        if value:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _signed32(value):
    """Interpret a decoded varint as int32 (negatives arrive as 2^64-x)."""
    if value >= 1 << 63:
        value -= 1 << 64
    return value


def _iter_fields(data):
    """Yield (field_number, wire_type, value) over one message's bytes.
    wire 0 -> int, wire 5 -> raw 4 bytes, wire 2 -> bytes, wire 1 -> 8 bytes."""
    pos = 0
    while pos < len(data):
        key, pos = _read_varint(data, pos)
        field, wire = key >> 3, key & 7
        if wire == 0:
            value, pos = _read_varint(data, pos)
        elif wire == 2:
            length, pos = _read_varint(data, pos)
            value = data[pos:pos + length]
            pos += length
        elif wire == 5:
            value = data[pos:pos + 4]
            pos += 4
        elif wire == 1:
            value = data[pos:pos + 8]
            pos += 8
        else:
            raise ValueError(f"unsupported wire type {wire}")
        yield field, wire, value


def _key(field, wire):
    return _write_varint((field << 3) | wire)


def _emit_string(field, text):
    raw = text.encode("utf-8")
    return _key(field, 2) + _write_varint(len(raw)) + raw


def _emit_message(field, payload):
    return _key(field, 2) + _write_varint(len(payload)) + payload


def _emit_float(field, value):
    return _key(field, 5) + struct.pack("<f", value)


def _emit_varint_field(field, value):
    return _key(field, 0) + _write_varint(value)


# ---------------------------------------------------------------------------
# ModelProto subset
# ---------------------------------------------------------------------------

def read_model(data):
    """Parse ModelProto bytes → dict with ``pieces`` [(text, score, type)],
    ``model_type``, control-id/piece trainer fields and normalizer flags.
    Unknown fields are skipped (forward-compatible)."""
    pieces = []
    trainer = {}
    normalizer = {}
    for field, wire, value in _iter_fields(data):
        if field == 1 and wire == 2:  # SentencePiece
            text, score, ptype = "", 0.0, NORMAL
            for f2, w2, v2 in _iter_fields(value):
                if f2 == 1 and w2 == 2:
                    text = v2.decode("utf-8")
                elif f2 == 2 and w2 == 5:
                    score = struct.unpack("<f", v2)[0]
                elif f2 == 3 and w2 == 0:
                    ptype = _signed32(v2)
            pieces.append((text, score, ptype))
        elif field == 2 and wire == 2:  # TrainerSpec
            for f2, w2, v2 in _iter_fields(value):
                if w2 == 0:
                    v2 = _signed32(v2)
                    if f2 == 3:
                        trainer["model_type"] = MODEL_TYPES.get(v2, "unigram")
                    elif f2 == 4:
                        trainer["vocab_size"] = v2
                    elif f2 == 20:
                        trainer["max_sentencepiece_length"] = v2
                    elif f2 == 22:
                        trainer["split_by_whitespace"] = bool(v2)
                    elif f2 == 40:
                        trainer["unk_id"] = v2
                    elif f2 == 41:
                        trainer["bos_id"] = v2
                    elif f2 == 42:
                        trainer["eos_id"] = v2
                    elif f2 == 43:
                        trainer["pad_id"] = v2
                elif w2 == 2 and f2 in (44, 45, 46, 47, 48):
                    key = {44: "unk_surface", 45: "unk_piece", 46: "bos_piece",
                           47: "eos_piece", 48: "pad_piece"}[f2]
                    trainer[key] = v2.decode("utf-8")
        elif field == 3 and wire == 2:  # NormalizerSpec
            for f2, w2, v2 in _iter_fields(value):
                if f2 == 3 and w2 == 0:
                    normalizer["add_dummy_prefix"] = bool(v2)
                elif f2 == 5 and w2 == 0:
                    normalizer["escape_whitespaces"] = bool(v2)
    return {
        "pieces": pieces,
        "model_type": trainer.get("model_type", "unigram"),
        "add_dummy_prefix": normalizer.get("add_dummy_prefix", True),
        "trainer": trainer,
        "normalizer": normalizer,
    }


def write_model(pieces, model_type="unigram", add_dummy_prefix=True,
                vocab_size=None, split_by_whitespace=True,
                max_sentencepiece_length=None,
                unk_id=None, bos_id=None, eos_id=None, pad_id=None):
    """Serialize the subset back to ModelProto bytes (loadable by the native
    ``sentencepiece`` library). ``pieces`` is [(text, score, type), ...]."""
    out = bytearray()
    for text, score, ptype in pieces:
        sub = _emit_string(1, text) + _emit_float(2, float(score))
        if ptype != NORMAL:  # NORMAL is the proto default
            sub += _emit_varint_field(3, ptype)
        out += _emit_message(1, bytes(sub))
    trainer = _emit_varint_field(3, MODEL_TYPE_IDS[model_type])
    if vocab_size is not None:
        trainer += _emit_varint_field(4, vocab_size)
    if max_sentencepiece_length is not None:
        trainer += _emit_varint_field(20, max_sentencepiece_length)
    trainer += _emit_varint_field(22, int(split_by_whitespace))
    for field, value in ((40, unk_id), (41, bos_id), (42, eos_id), (43, pad_id)):
        if value is not None:
            trainer += _emit_varint_field(field, value)
    out += _emit_message(2, bytes(trainer))
    normalizer = (_emit_string(1, "identity")
                  + _emit_varint_field(3, int(add_dummy_prefix))
                  + _emit_varint_field(5, 1))  # escape_whitespaces
    out += _emit_message(3, bytes(normalizer))
    return bytes(out)


def looks_like_model_proto(head):
    """Cheap sniff: ModelProto files start with the pieces field key 0x0a
    (field 1, wire 2); our JSON models start with '{'."""
    return bool(head) and head[:1] == b"\x0a"
