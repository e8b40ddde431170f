"""Tokenizers (port of ``svt_speechbrain_tpu/tokenizers/sentence_piece.py``,
itself the analogue of SpeechBrain's ``tokenizers/SentencePiece.py``).

``SentencePiece`` trains and loads a BPE/unigram/char model from manifest
text through the native ``sentencepiece`` package when it is installed,
else through the port's pure-python :mod:`.spm_lite` (the same train →
encode → decode surface). Its ``__call__`` takes and returns tensors, the
ids on the caller's device. ``CharTokenizer``/``WordTokenizer`` are
self-contained fallbacks with the same encode/decode call shape.
"""
from __future__ import annotations

import csv
import json
import logging
import os

import numpy as np
import torch

from svt_speechbrain_tpu_torch.dataio.dataio import merge_char
from svt_speechbrain_tpu_torch.utils import edit_distance

logger = logging.getLogger(__name__)


def _backend():
    """The native sentencepiece package when available, else spm_lite."""
    try:
        import sentencepiece as spm

        return spm
    except ImportError:
        from svt_speechbrain_tpu_torch.tokenizers import spm_lite

        return spm_lite


class SentencePiece:
    """BPE/unigram/char tokenizer trained from a CSV/JSON manifest column
    (reference ``SentencePiece.py:20-140``): trains on first use into
    ``<model_dir>/<vocab_size>_<model_type>.model``, then encodes label
    batches to subword id arrays and decodes them back to word sequences.

    Example
    -------
    >>> import tempfile, csv, os
    >>> d = tempfile.mkdtemp()
    >>> path = os.path.join(d, "train.csv")
    >>> with open(path, "w", newline="") as f:
    ...     w = csv.DictWriter(f, fieldnames=["ID", "wrd"])
    ...     _ = w.writeheader()
    ...     w.writerows([{"ID": "1", "wrd": "HELLO MORNING"},
    ...                  {"ID": "2", "wrd": "GOOD MORNING HELLO"}])
    >>> sp = SentencePiece(d, 24, annotation_train=path,
    ...                    annotation_read="wrd", model_type="unigram")
    >>> ids, pieces = sp([["HELLO", "MORNING"]], task="encode_from_list")
    >>> sp([list(map(int, ids[0]))], task="decode_from_list")
    [['HELLO', 'MORNING']]
    """

    def __init__(self, model_dir, vocab_size, annotation_train=None,
                 annotation_read=None, model_type="unigram",
                 char_format_input=False, character_coverage=1.0,
                 user_defined_symbols=None, max_sentencepiece_length=10,
                 bos_id=-1, eos_id=-1, pad_id=-1, unk_id=0,
                 split_by_whitespace=True, num_sequences=None,
                 annotation_list_to_check=None, annotation_format="csv",
                 add_dummy_prefix=True):
        if model_type not in ("unigram", "bpe", "char"):
            raise ValueError("model_type must be one of: [unigram, bpe, char]")
        if not isinstance(vocab_size, int):
            raise ValueError("vocab_size must be integer.")
        spm = _backend()
        os.makedirs(model_dir, exist_ok=True)
        self.annotation_train = annotation_train
        self.annotation_read = annotation_read
        self.annotation_format = annotation_format
        self.char_format_input = char_format_input
        self.model_type = model_type
        self.num_sequences = num_sequences
        self.prefix_model_file = os.path.join(
            model_dir, f"{vocab_size}_{model_type}")
        if not os.path.isfile(self.prefix_model_file + ".model"):
            logger.info(f"Train tokenizer with type: {model_type}")
            assert annotation_train is not None, (
                "no trained model found and no annotation_train given")
            text_file = self.prefix_model_file + ".txt"
            self._annotation2text(text_file)
            kwargs = dict(
                input=text_file, model_prefix=self.prefix_model_file,
                model_type=model_type, character_coverage=character_coverage,
                max_sentencepiece_length=max_sentencepiece_length,
                bos_id=bos_id, eos_id=eos_id, pad_id=pad_id, unk_id=unk_id,
                add_dummy_prefix=add_dummy_prefix)
            if model_type != "char":
                kwargs["vocab_size"] = vocab_size
            if user_defined_symbols is not None:
                kwargs["user_defined_symbols"] = user_defined_symbols
            if not split_by_whitespace:
                kwargs["split_by_whitespace"] = False
            spm.SentencePieceTrainer.train(**kwargs)
        else:
            logger.info("Tokenizer is already trained.")
        self.sp = spm.SentencePieceProcessor()
        self.sp.load(self.prefix_model_file + ".model")
        if annotation_list_to_check is not None:
            self._check_coverage_from_bpe(annotation_list_to_check)

    # ------------------------------------------------------- manifest → text
    def _annotation2text(self, text_file):
        """Extract the ``annotation_read`` column into one-sentence-per-line
        text (reference ``_csv2text``/``_json2text``, incl. the
        ``row_idx > num_sequences`` truncation quirk)."""
        if not os.path.isfile(os.path.abspath(self.annotation_train)):
            raise ValueError(
                f"{self.annotation_train} is not a file. please provide "
                "annotation file for training.")
        if self.annotation_format == "csv":
            with open(self.annotation_train, newline="") as f:
                reader = csv.DictReader(f)
                if self.annotation_read not in (reader.fieldnames or ()):
                    raise ValueError(
                        f"{self.annotation_read} must exist in: "
                        f"{self.annotation_train}")
                rows = [r[self.annotation_read] for r in reader]
        elif self.annotation_format == "json":
            with open(self.annotation_train) as f:
                data = json.load(f)
            rows = [entry[self.annotation_read] for entry in data.values()]
        else:
            raise ValueError(
                "Annotation format not supported. Supported formats are csv "
                f"and json. Got {self.annotation_format}")
        with open(text_file, "w") as out:
            for row_idx, sent in enumerate(rows):
                if (self.num_sequences is not None
                        and row_idx > self.num_sequences):
                    logger.info(f"Using {self.num_sequences} sequences to "
                                "train the tokenizer.")
                    break
                if self.char_format_input:
                    (words,) = merge_char([sent.split()])
                    sent = " ".join(words)
                out.write(sent + "\n")
        logger.info(f"Text file created at: {text_file}")

    def _check_coverage_from_bpe(self, list_annotation_files):
        """Log how many words fail the encode→decode round trip
        (reference ``_check_coverage_from_bpe``)."""
        for annotation_file in list_annotation_files:
            if not os.path.isfile(os.path.abspath(annotation_file)):
                logger.info(f"No accuracy recover checking for "
                            f"{annotation_file}")
                continue
            if self.annotation_format == "csv":
                with open(annotation_file, newline="") as f:
                    reader = csv.DictReader(f)
                    rows = [r[self.annotation_read] for r in reader]
            else:
                with open(annotation_file) as f:
                    data = json.load(f)
                rows = [entry[self.annotation_read]
                        for entry in data.values()]
            wrong = []
            for row in rows:
                if self.char_format_input:
                    (words,) = merge_char([row.split()])
                    row = " ".join(words)
                row = row.split("\n")[0]
                decoded = self.sp.decode_ids(self.sp.encode_as_ids(row))
                (details,) = edit_distance.wer_details_for_batch(
                    ["utt1"], [row.split(" ")], [decoded.split(" ")],
                    compute_alignments=True)
                if details["WER"] > 0:
                    for align in details["alignment"]:
                        if align[0] != "=" and align[1] is not None:
                            if align[1] not in wrong:
                                wrong.append(align[1])
            if wrong:
                logger.warning(f"Wrong recover words: {len(wrong)}")
                logger.warning(
                    "accuracy recovering words: "
                    f"{1 - len(wrong) / self.sp.vocab_size()}")
            else:
                logger.info("Wrong recover words: 0")

    # -------------------------------------------------------------- calling
    def __call__(self, batch, batch_lens=None, ind2lab=None, task="encode"):
        """Encode label batches to subword ids / decode them back
        (``sentence_piece.py:192``; tensors where the JAX wrapper takes and
        returns numpy arrays).

        ``task="encode"``: ``batch`` (B, L) int tensor + ``batch_lens``
        relative lengths + ``ind2lab`` → (padded f32 id tensor, relative
        id lengths), both on ``batch``'s device. ``task="decode"``: the
        inverse to word lists. ``task="decode_from_list"``: list of id
        sequences → word lists. ``task="encode_from_list"``: list of
        token-string lists → (padded ids, lens) on the CPU, without an
        ind2lab.
        """
        if task == "encode" and ind2lab is None:
            raise ValueError("Tokenizer encoder must have the ind2lab function")
        if task in ("encode", "encode_from_list"):
            device = torch.device("cpu")
            if task == "encode":
                batch = torch.as_tensor(batch)
                device = batch.device
                rows = batch.cpu().numpy()
                abs_lens = np.rint(torch.as_tensor(batch_lens).cpu().numpy()
                                   * rows.shape[1]).astype(int)
                seqs = [[ind2lab[int(t)] for t in row[:n]]
                        for row, n in zip(rows, abs_lens)]
            else:
                seqs = batch
            bpe = []
            for tokens in seqs:
                if self.char_format_input:
                    (words,) = merge_char([tokens])
                    sent = " ".join(words)
                else:
                    sent = " ".join(tokens)
                bpe.append(self.sp.encode_as_ids(sent))
            max_len = max((len(s) for s in bpe), default=0)
            ids = np.zeros((len(bpe), max_len), np.float32)
            lens = np.zeros((len(bpe),), np.float32)
            for i, s in enumerate(bpe):
                ids[i, :len(s)] = s
                lens[i] = len(s) / max_len if max_len else 0.0
            return (torch.from_numpy(ids).to(device),
                    torch.from_numpy(lens).to(device))
        if task == "decode_from_list":
            return [self.sp.decode_ids(list(map(int, seq))).split(" ")
                    for seq in batch]
        if task == "decode":
            rows = torch.as_tensor(batch).cpu().numpy()
            abs_lens = np.rint(torch.as_tensor(batch_lens).cpu().numpy()
                               * rows.shape[1]).astype(int)
            return [self.sp.decode_ids(
                        [int(t) for t in row[:n]]).split(" ")
                    for row, n in zip(rows, abs_lens)]
        raise ValueError(task)


class CharTokenizer:
    """Character-level tokenizer with the SentencePiece call surface.

    Example
    -------
    >>> tok = CharTokenizer(vocab=["abc", "cab"])
    >>> ids = tok.encode("cab")
    >>> ids, tok.decode(ids), tok.vocab_size   # id 0 reserved for unk
    ([3, 1, 2], 'cab', 4)
    """

    def __init__(self, vocab=None, unk_id=0):
        self.unk_id = unk_id
        self.char2id = {}
        self.id2char = {}
        if vocab:
            self.fit(vocab)

    def fit(self, texts):
        chars = sorted({c for t in texts for c in t})
        self.char2id = {c: i + 1 for i, c in enumerate(chars)}
        self.id2char = {i: c for c, i in self.char2id.items()}
        return self

    @property
    def vocab_size(self):
        return len(self.char2id) + 1

    def encode(self, text):
        return [self.char2id.get(c, self.unk_id) for c in text]

    def decode(self, ids):
        return "".join(self.id2char.get(int(i), "") for i in ids)

    def __call__(self, batch, task="encode"):
        if task == "encode":
            return [self.encode(t) for t in batch]
        return [self.decode(seq) for seq in batch]


class WordTokenizer:
    """Whitespace word tokenizer with a fitted vocabulary."""

    def __init__(self, unk_id=0):
        self.unk_id = unk_id
        self.word2id = {}
        self.id2word = {}

    def fit(self, texts):
        words = sorted({w for t in texts for w in t.split()})
        self.word2id = {w: i + 1 for i, w in enumerate(words)}
        self.id2word = {i: w for w, i in self.word2id.items()}
        return self

    def encode(self, text):
        return [self.word2id.get(w, self.unk_id) for w in text.split()]

    def decode(self, ids):
        return " ".join(self.id2word.get(int(i), "<unk>") for i in ids)
