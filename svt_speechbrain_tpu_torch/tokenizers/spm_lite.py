"""Pure-python SentencePiece-compatible subword trainer + processor.

The reference trains Google's ``sentencepiece`` BPE/unigram models from
manifest text (``speechbrain/tokenizers/SentencePiece.py:20-140``); that
native library is not in the TPU image, so this module implements the same
train → encode → decode surface in plain python:

* **unigram**: substring seed vocabulary → EM over the segmentation lattice
  (forward/backward expected piece counts, the Kudo 2018 recipe) →
  iterative pruning to the target vocab size; Viterbi encoding.
* **bpe**: classic highest-frequency pair merges; rank-order encoding.
* **char** / **word**: degenerate single-symbol models.

Text normalization follows SentencePiece's visible-whitespace convention:
spaces become ``▁`` (U+2581) and ``add_dummy_prefix`` prepends one to the
sentence, so ``decode(encode(s)) == s`` for whitespace-normal text.

The model file (``<prefix>.model``) is Google's ModelProto protobuf, written
and read by the pure-python wire-format walker in
:mod:`~svt_speechbrain_tpu_torch.tokenizers.spm_proto` — so real pretrained
``.model`` files load here without the native lib, and models trained here
load in the native lib (``model_format="json"`` keeps the old JSON format).
A ``<prefix>.vocab`` TSV twin is written like the real trainer's.
``SentencePieceProcessor``/``SentencePieceTrainer`` mirror the
``sentencepiece`` package's API so ``tokenizers.sentence_piece`` can use
either backend interchangeably.

Example
-------
>>> import tempfile, os
>>> corpus = ["the cat sat on the mat", "the cat ate the rat",
...           "a rat sat on a mat"] * 4
>>> prefix = os.path.join(tempfile.mkdtemp(), "m")
>>> _ = SentencePieceTrainer.train(
...     input=_write_lines(corpus, prefix + ".txt"),
...     model_prefix=prefix, vocab_size=24, model_type="unigram")
>>> sp = SentencePieceProcessor().load(prefix + ".model")
>>> sp.vocab_size()
24
>>> sp.encode_as_pieces("the cat sat")   # whole words won unigram seats
['▁the', '▁cat', '▁sat']
>>> sp.decode_ids(sp.encode_as_ids("the cat sat"))
'the cat sat'

The port's copy of ``svt_speechbrain_tpu/tokenizers/spm_lite.py`` (pure Python), kept
identical but for its imports.
"""
from __future__ import annotations

import json
import math
import os
from collections import Counter

WS = "▁"  # SentencePiece's visible space
UNK_PIECE, BOS_PIECE, EOS_PIECE, PAD_PIECE = "<unk>", "<s>", "</s>", "<pad>"


def _write_lines(lines, path):
    with open(path, "w") as f:
        for line in lines:
            f.write(line + "\n")
    return path


def normalize(text, add_dummy_prefix=True):
    """Whitespace-collapse and mark spaces with ``▁``.

    Example
    -------
    >>> normalize("hello  world")
    '▁hello▁world'
    >>> normalize("hello", add_dummy_prefix=False)
    'hello'
    """
    text = WS.join(text.split())
    return (WS + text) if add_dummy_prefix and text else text


def denormalize(pieces):
    """Inverse of :func:`normalize` over concatenated pieces."""
    return "".join(pieces).replace(WS, " ").strip()


# ---------------------------------------------------------------------------
# Unigram training (Kudo 2018): seed → EM → prune
# ---------------------------------------------------------------------------

def _word_counts(sentences, add_dummy_prefix=True, split_by_whitespace=True):
    counts = Counter()
    for s in sentences:
        if split_by_whitespace:
            for w in s.split():
                counts[(WS if add_dummy_prefix else "") + w] += 1
        else:
            counts[normalize(s, add_dummy_prefix)] += 1
    return counts


def _seed_vocab(word_counts, seed_size, max_len):
    """Substring candidates scored by count·len (longer pieces that cover
    frequent spans win seats), all single characters always included."""
    subs = Counter()
    chars = Counter()
    for w, c in word_counts.items():
        for i in range(len(w)):
            chars[w[i]] += c
            for j in range(i + 2, min(len(w), i + max_len) + 1):
                subs[w[i:j]] += c
    ranked = sorted(subs.items(), key=lambda kv: (-kv[1] * len(kv[0]), kv[0]))
    seeds = dict(chars)
    for piece, c in ranked:
        if len(seeds) >= seed_size + len(chars):
            break
        seeds.setdefault(piece, c)
    total = sum(seeds.values())
    return {p: math.log(c / total) for p, c in seeds.items()}


def _forward_backward(word, logp, max_len):
    """Expected piece counts for one word under the unigram lattice.
    Returns (counts dict, log marginal likelihood)."""
    n = len(word)
    alpha = [-math.inf] * (n + 1)
    alpha[0] = 0.0
    edges = []  # (start, end, piece, logp)
    for i in range(n):
        if alpha[i] == -math.inf:
            continue
        for j in range(i + 1, min(n, i + max_len) + 1):
            lp = logp.get(word[i:j])
            if lp is None:
                continue
            edges.append((i, j, word[i:j], lp))
            cand = alpha[i] + lp
            alpha[j] = cand if alpha[j] == -math.inf else (
                max(alpha[j], cand) + math.log1p(
                    math.exp(min(alpha[j], cand) - max(alpha[j], cand))))
    if alpha[n] == -math.inf:
        return {}, -math.inf
    beta = [-math.inf] * (n + 1)
    beta[n] = 0.0
    for i, j, piece, lp in reversed(edges):
        cand = lp + beta[j]
        beta[i] = cand if beta[i] == -math.inf else (
            max(beta[i], cand) + math.log1p(
                math.exp(min(beta[i], cand) - max(beta[i], cand))))
    z = alpha[n]
    counts = {}
    for i, j, piece, lp in edges:
        gamma = math.exp(alpha[i] + lp + beta[j] - z)
        counts[piece] = counts.get(piece, 0.0) + gamma
    return counts, z


def _viterbi(word, logp, max_len, unk_penalty=-20.0):
    """Best segmentation of ``word``; unknown characters become single-char
    pieces with a large penalty (encoded as unk downstream)."""
    n = len(word)
    best = [-math.inf] * (n + 1)
    back = [None] * (n + 1)
    best[0] = 0.0
    for i in range(n):
        if best[i] == -math.inf:
            continue
        for j in range(i + 1, min(n, i + max_len) + 1):
            lp = logp.get(word[i:j])
            if lp is None:
                continue
            if best[i] + lp > best[j]:
                best[j] = best[i] + lp
                back[j] = i
        # the unk edge (single char, heavy penalty) is always in the lattice
        if best[i] + unk_penalty > best[i + 1]:
            best[i + 1] = best[i] + unk_penalty
            back[i + 1] = i
    pieces = []
    j = n
    while j > 0:
        i = back[j]
        pieces.append(word[i:j])
        j = i
    return list(reversed(pieces))


def train_unigram(sentences, vocab_size, max_len=10, seed_factor=8,
                  em_iters=4, prune_frac=0.25, add_dummy_prefix=True,
                  split_by_whitespace=True, required=()):
    """EM-train a unigram piece inventory. Returns (pieces, scores) with
    specials excluded (the caller lays out ids)."""
    wc = _word_counts(sentences, add_dummy_prefix, split_by_whitespace)
    chars = {c for w in wc for c in w}
    logp = _seed_vocab(wc, seed_factor * vocab_size, max_len)
    for p in required:
        logp.setdefault(p, math.log(1e-7))
    target = max(vocab_size, len(chars) + len(required))
    while True:
        for _ in range(em_iters):
            expected = Counter()
            for w, c in wc.items():
                counts, _ = _forward_backward(w, logp, max_len)
                for p, g in counts.items():
                    expected[p] += g * c
            total = sum(expected.values()) or 1.0
            # zero-count pieces keep a floor score (they rank last and the
            # prune phase removes them first) so the final inventory hits
            # the requested size exactly whenever the corpus supports it
            logp = {p: math.log(max(expected.get(p, 0.0), 1e-12) / total)
                    for p in logp}
        removable = [p for p in logp
                     if len(p) > 1 and p not in required]
        if len(logp) <= target or not removable:
            break
        n_drop = min(len(removable),
                     max(1, int(len(removable) * prune_frac)),
                     len(logp) - target)
        for p in sorted(removable, key=lambda p: logp[p])[:n_drop]:
            del logp[p]
    pieces = sorted(logp, key=lambda p: (-logp[p], p))[:target]
    return pieces, [logp[p] for p in pieces]


# ---------------------------------------------------------------------------
# BPE training
# ---------------------------------------------------------------------------

def train_bpe(sentences, vocab_size, add_dummy_prefix=True,
              split_by_whitespace=True, required=()):
    """Highest-frequency pair merges until the inventory reaches
    ``vocab_size``. Returns (pieces, scores, merges) — scores are
    ``-merge_rank`` for merged pieces (SentencePiece's BPE convention),
    below-all-merges for the base characters."""
    wc = _word_counts(sentences, add_dummy_prefix, split_by_whitespace)
    words = {w: list(w) for w in wc}
    chars = sorted({c for w in wc for c in w})
    merges = []
    inventory = list(required) + chars
    while len(inventory) < vocab_size:
        pairs = Counter()
        for w, syms in words.items():
            c = wc[w]
            for a, b in zip(syms, syms[1:]):
                pairs[(a, b)] += c
        if not pairs:
            break
        (a, b), _ = max(pairs.items(), key=lambda kv: (kv[1], kv[0]))
        merges.append((a, b))
        inventory.append(a + b)
        for w, syms in words.items():
            i, out = 0, []
            while i < len(syms):
                if i + 1 < len(syms) and syms[i] == a and syms[i + 1] == b:
                    out.append(a + b)
                    i += 2
                else:
                    out.append(syms[i])
                    i += 1
            words[w] = out
    merged = inventory[len(required) + len(chars):]
    pieces = list(required) + merged + chars
    scores = ([0.0] * len(required)
              + [-float(r) for r in range(len(merged))]
              + [-float(len(merged) + i) for i in range(len(chars))])
    return pieces, scores, merges


def _bpe_encode(word, merges_rank):
    syms = list(word)
    while len(syms) > 1:
        best, best_rank = None, None
        for i, (a, b) in enumerate(zip(syms, syms[1:])):
            r = merges_rank.get((a, b))
            if r is not None and (best_rank is None or r < best_rank):
                best, best_rank = i, r
        if best is None:
            break
        syms[best:best + 2] = [syms[best] + syms[best + 1]]
    return syms


def _split_user_defined(text, symbols):
    """Extract user-defined symbols as whole spans before the subword
    algorithm runs (native sentencepiece segments them out first for every
    model type). Returns ``[(chunk, is_symbol), ...]`` splitting on the
    symbols longest-first.

    Example
    -------
    >>> _split_user_defined("a<sep>b", ["<sep>"])
    [('a', False), ('<sep>', True), ('b', False)]
    """
    out = [(text, False)]
    for sym in sorted(symbols, key=len, reverse=True):
        nxt = []
        for chunk, is_sym in out:
            if is_sym:
                nxt.append((chunk, True))
                continue
            parts = chunk.split(sym)
            for k, part in enumerate(parts):
                if k:
                    nxt.append((sym, True))
                if part:
                    nxt.append((part, False))
        out = nxt
    return out


# ---------------------------------------------------------------------------
# Processor + trainer shims (the ``sentencepiece`` API surface we use)
# ---------------------------------------------------------------------------

class SentencePieceProcessor:
    """Drop-in for ``sentencepiece.SentencePieceProcessor``. Loads BOTH model
    formats: Google's protobuf ``.model`` (the files every published
    SpeechBrain/HF pretrained tokenizer ships — parsed without the native lib
    via :mod:`~svt_speechbrain_tpu_torch.tokenizers.spm_proto`) and the JSON format
    earlier versions of :class:`SentencePieceTrainer` wrote."""

    def load(self, path):
        from svt_speechbrain_tpu_torch.tokenizers import spm_proto

        with open(path, "rb") as f:
            raw = f.read()
        if spm_proto.looks_like_model_proto(raw):
            self._load_proto(spm_proto, raw)
        else:
            self._load_json(raw, path)
        self.max_len = max((len(p) for p in self.pieces), default=1)
        self._ids = {p: i for i, p in enumerate(self.pieces)}
        if self.model_type == "bpe":
            self._reconstruct_merges()
        self._logp = {p: s for p, s in zip(self.pieces, self.scores)
                      if not self._is_control(p)}
        return self

    def _load_json(self, raw, path):
        model = json.loads(raw.decode("utf-8"))
        if model.get("format") != "spm_lite/1":
            raise ValueError(f"not a sentencepiece model file: {path}")
        self.model_type = model["model_type"]
        self.pieces = model["pieces"]
        self.scores = model["scores"]
        self.unk_id_ = model["unk_id"]
        self.add_dummy_prefix = model.get("add_dummy_prefix", True)
        self.user_defined = model.get("user_defined", [])
        self._controls = {p for p in (UNK_PIECE, BOS_PIECE, EOS_PIECE,
                                      PAD_PIECE) if p in self.pieces}
        self._unk_piece = UNK_PIECE

    def _load_proto(self, spm_proto, raw):
        model = spm_proto.read_model(raw)
        self.model_type = model["model_type"]
        self.pieces = [t for t, _, _ in model["pieces"]]
        self.scores = [s for _, s, _ in model["pieces"]]
        self.add_dummy_prefix = model["add_dummy_prefix"]
        self.user_defined = [t for t, _, k in model["pieces"]
                             if k == spm_proto.USER_DEFINED]
        self._controls = {t for t, _, k in model["pieces"]
                          if k in (spm_proto.CONTROL, spm_proto.UNKNOWN)}
        unknowns = [i for i, (_, _, k) in enumerate(model["pieces"])
                    if k == spm_proto.UNKNOWN]
        self.unk_id_ = unknowns[0] if unknowns else model["trainer"].get("unk_id", 0)
        self._unk_piece = (self.pieces[unknowns[0]] if unknowns
                           else model["trainer"].get("unk_piece", UNK_PIECE))

    def _reconstruct_merges(self):
        """BPE merge ranks from piece scores (score == -merge_rank, the
        sentencepiece convention): native BPE inference merges the adjacent
        pair whose CONCATENATION is the best-scoring in-vocab piece, so every
        two-way split of a normal piece is a candidate pair at that piece's
        rank. Works for protobuf models (which carry no merge list) and for
        our own JSON/proto output alike."""
        self.merges_rank = {}
        skip = self._controls | set(self.user_defined)
        for piece, score in zip(self.pieces, self.scores):
            if piece in skip or len(piece) < 2:
                continue
            rank = -score
            for k in range(1, len(piece)):
                a, b = piece[:k], piece[k:]
                if a in self._ids and b in self._ids \
                        and a not in skip and b not in skip:
                    pair = (a, b)
                    if rank < self.merges_rank.get(pair, math.inf):
                        self.merges_rank[pair] = rank

    def _is_control(self, piece):
        return piece in self._controls

    def vocab_size(self):
        return len(self.pieces)

    def get_piece_size(self):
        return len(self.pieces)

    def id_to_piece(self, i):
        return self.pieces[i]

    def piece_to_id(self, piece):
        return self._ids.get(piece, self.unk_id_)

    def unk_id(self):
        return self.unk_id_

    def encode_as_pieces(self, text):
        text = normalize(text, self.add_dummy_prefix)
        pieces = []
        for chunk, is_sym in _split_user_defined(text, self.user_defined):
            if is_sym:
                pieces.append(chunk)
            elif self.model_type == "word":
                # native sentencepiece extracts user-defined symbols for
                # every model type; word-split only the non-symbol chunks
                prefix = WS if self.add_dummy_prefix else ""
                pieces.extend(prefix + w for w in chunk.split(WS) if w)
            elif self.model_type == "char":
                pieces.extend(chunk)
            elif self.model_type == "bpe":
                pieces.extend(_bpe_encode(chunk, self.merges_rank))
            else:
                pieces.extend(_viterbi(chunk, self._logp, self.max_len))
        return pieces

    def encode_as_ids(self, text):
        return [self.piece_to_id(p) for p in self.encode_as_pieces(text)]

    def decode_pieces(self, pieces):
        return denormalize(p if p != self._unk_piece else " ⁇ "
                           for p in pieces)

    def decode_ids(self, ids):
        return self.decode_pieces([self.pieces[int(i)] for i in ids])

    # sentencepiece's modern aliases
    encode = encode_as_ids
    decode = decode_ids


class SentencePieceTrainer:
    """Drop-in for ``sentencepiece.SentencePieceTrainer`` (kwargs call style
    plus the ``--key=value`` query-string style the reference's
    ``_train_BPE`` uses, ``SentencePiece.py:268-300``)."""

    @staticmethod
    def train(arg_string=None, **kwargs):
        if arg_string is not None:
            for part in arg_string.split("--"):
                part = part.strip()
                if part:
                    key, _, val = part.partition("=")
                    kwargs.setdefault(key.strip(), val.strip())
        input_path = kwargs["input"]
        prefix = kwargs["model_prefix"]
        model_type = kwargs.get("model_type", "unigram")
        vocab_size = int(kwargs.get("vocab_size", 8000))
        add_dummy_prefix = str(kwargs.get("add_dummy_prefix",
                                          "True")).lower() != "false"
        split_ws = str(kwargs.get("split_by_whitespace",
                                  "True")).lower() != "false"
        unk_id = int(kwargs.get("unk_id", 0))
        bos_id = int(kwargs.get("bos_id", -1))
        eos_id = int(kwargs.get("eos_id", -1))
        pad_id = int(kwargs.get("pad_id", -1))
        max_len = int(kwargs.get("max_sentencepiece_length", 10))
        # native sentencepiece errors on a control id outside the inventory;
        # without this check the id would be silently dropped and the
        # persisted unk_id could point past the end of the pieces list
        for name, pid in (("unk_id", unk_id), ("bos_id", bos_id),
                          ("eos_id", eos_id), ("pad_id", pad_id)):
            if pid >= vocab_size:
                raise ValueError(
                    f"{name}={pid} must be < vocab_size={vocab_size}")
        user_defined = kwargs.get("user_defined_symbols") or []
        if isinstance(user_defined, str):
            user_defined = [s for s in user_defined.split(",") if s]

        with open(input_path) as f:
            sentences = [line.rstrip("\n") for line in f]

        # control-symbol layout: ids fixed by the requested slots
        controls = {}
        for pid, piece in ((unk_id, UNK_PIECE), (bos_id, BOS_PIECE),
                           (eos_id, EOS_PIECE), (pad_id, PAD_PIECE)):
            if pid >= 0:
                controls[pid] = piece
        n_specials = len(controls) + len(user_defined)
        inner_size = vocab_size - n_specials

        merges = []
        if model_type == "unigram":
            pieces, scores = train_unigram(
                sentences, inner_size, max_len=max_len,
                add_dummy_prefix=add_dummy_prefix,
                split_by_whitespace=split_ws, required=tuple(user_defined))
        elif model_type == "bpe":
            pieces, scores, merges = train_bpe(
                sentences, inner_size, add_dummy_prefix=add_dummy_prefix,
                split_by_whitespace=split_ws, required=tuple(user_defined))
        elif model_type == "char":
            wc = _word_counts(sentences, add_dummy_prefix, split_ws)
            counts = Counter()
            for w, c in wc.items():
                for ch in w:
                    counts[ch] += c
            total = sum(counts.values())
            ranked = sorted(counts.items(), key=lambda kv: (-kv[1], kv[0]))
            pieces = [p for p, _ in ranked]
            scores = [math.log(c / total) for _, c in ranked]
        elif model_type == "word":
            wc = _word_counts(sentences, add_dummy_prefix, split_ws)
            total = sum(wc.values())
            ranked = sorted(wc.items(), key=lambda kv: (-kv[1], kv[0]))
            pieces = [p for p, _ in ranked][:inner_size]
            scores = [math.log(c / total) for _, c in ranked][:inner_size]
        else:
            raise ValueError(f"unknown model_type: {model_type}")

        # user_defined symbols lead (after controls), as in sentencepiece
        tail = [p for p in pieces if p not in user_defined]
        tail_scores = [s for p, s in zip(pieces, scores)
                       if p not in user_defined]
        final_pieces, final_scores = [], []
        inner = iter(zip(list(user_defined) + tail, [0.0] * len(user_defined)
                         + tail_scores))
        i = 0
        pending = dict(controls)
        while len(final_pieces) < vocab_size:
            if i in pending:
                final_pieces.append(pending.pop(i))
                final_scores.append(0.0)
            else:
                try:
                    p, s = next(inner)
                except StopIteration:
                    # corpus too small to fill vocab_size: the remaining
                    # control symbols' requested ids are out of range of the
                    # shrunken inventory — append them (id order) so every
                    # control still holds a seat
                    for pid in sorted(pending):
                        final_pieces.append(pending.pop(pid))
                        final_scores.append(0.0)
                    break
                final_pieces.append(p)
                final_scores.append(s)
            i += 1
        # the persisted unk_id must point at <unk>'s actual slot even when
        # the inventory came up short of the requested layout
        if UNK_PIECE in final_pieces:
            unk_id = final_pieces.index(UNK_PIECE)

        model_format = kwargs.get("model_format", "proto")
        if model_format == "proto":
            # Google's ModelProto wire format — the file the native
            # sentencepiece library (and every published pipeline) loads
            from svt_speechbrain_tpu_torch.tokenizers import spm_proto

            controls = {BOS_PIECE, EOS_PIECE, PAD_PIECE}
            typed = []
            for p, s in zip(final_pieces, final_scores):
                if p == UNK_PIECE:
                    ptype = spm_proto.UNKNOWN
                elif p in controls:
                    ptype = spm_proto.CONTROL
                elif p in user_defined:
                    ptype = spm_proto.USER_DEFINED
                else:
                    ptype = spm_proto.NORMAL
                typed.append((p, s, ptype))
            raw = spm_proto.write_model(
                typed, model_type=model_type,
                add_dummy_prefix=add_dummy_prefix,
                vocab_size=len(final_pieces),
                split_by_whitespace=split_ws,
                max_sentencepiece_length=max_len, unk_id=unk_id,
                bos_id=bos_id, eos_id=eos_id, pad_id=pad_id)
            with open(prefix + ".model", "wb") as f:
                f.write(raw)
        else:
            model = {
                "format": "spm_lite/1",
                "model_type": model_type,
                "pieces": final_pieces,
                "scores": final_scores,
                "unk_id": unk_id,
                "add_dummy_prefix": add_dummy_prefix,
                "merges": [list(m) for m in merges],
                "user_defined": list(user_defined),
            }
            with open(prefix + ".model", "w") as f:
                json.dump(model, f, ensure_ascii=False)
        with open(prefix + ".vocab", "w") as f:
            for p, s in zip(final_pieces, final_scores):
                f.write(f"{p}\t{s:g}\n")
        return prefix + ".model"
