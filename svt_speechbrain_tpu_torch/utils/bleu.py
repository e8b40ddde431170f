"""BLEU scoring — REFERENCE-EXACT (``speechbrain/utils/bleu.py``); a copy
of ``svt_speechbrain_tpu/utils/bleu.py``.

The reference wraps sacrebleu; so do we when it is importable (golden-tested
in ``tests/test_metrics_golden.py``), with the same append contract
(``ind2lab`` mapping, word merging into sentence strings, per-reference-
stream target accumulation) and the same summary fields (``BLEU``, ``BP``,
``ratio``, ``hyp_len``, ``ref_len``, ``precisions``, ``bleu_score``).
Without sacrebleu, a self-contained corpus BLEU (standard clipped
up-to-4-gram precision + brevity penalty, no smoothing) fills in ``BLEU``.
"""
from __future__ import annotations

import collections
import math


def merge_words(sequences):
    """Word lists -> space-joined phrases (reference ``bleu.py:4``).

    Example
    -------
    >>> merge_words([["hello", "world"]])
    ['hello world']
    """
    return [" ".join(seq) for seq in sequences]


def _ngrams(tokens, n):
    return collections.Counter(
        tuple(tokens[i:i + n]) for i in range(len(tokens) - n + 1))


def corpus_bleu(hypotheses, references, max_n=4):
    """Self-contained corpus BLEU over token lists (fallback scorer);
    references: list of lists of token lists. Returns BLEU in [0, 100].

    Example
    -------
    >>> hyp = [["the", "cat", "sat", "on", "the", "mat"]]
    >>> refs = [[["the", "cat", "sat", "on", "the", "mat"]]]
    >>> round(corpus_bleu(hyp, refs), 1)   # perfect match
    100.0
    >>> corpus_bleu([["dog"]], refs)
    0.0
    """
    clipped = [0] * max_n
    totals = [0] * max_n
    hyp_len = 0
    ref_len = 0
    for hyp, refs in zip(hypotheses, references):
        hyp_len += len(hyp)
        ref_len += min((abs(len(r) - len(hyp)), len(r)) for r in refs)[1]
        for n in range(1, max_n + 1):
            hyp_counts = _ngrams(hyp, n)
            max_ref = collections.Counter()
            for r in refs:
                for gram, c in _ngrams(r, n).items():
                    max_ref[gram] = max(max_ref[gram], c)
            for gram, c in hyp_counts.items():
                clipped[n - 1] += min(c, max_ref.get(gram, 0))
            totals[n - 1] += max(len(hyp) - n + 1, 0)
    # drop orders with no n-grams at all (short corpora); zero clipped counts
    # at a populated order still zero the score
    pairs = [(c, t) for c, t in zip(clipped, totals) if t > 0]
    if not pairs or any(c == 0 for c, _ in pairs):
        return 0.0
    log_precision = sum(math.log(c / t) for c, t in pairs) / len(pairs)
    bp = 1.0 if hyp_len > ref_len else math.exp(1 - ref_len / max(hyp_len, 1))
    return 100.0 * bp * math.exp(log_precision)


class BLEUStats:
    """Accumulate translations and score (reference ``bleu.py:22``).

    ``targets`` is a list of REFERENCE STREAMS (each a batch of word
    sequences) — one stream per alternative translation, all streams the
    same batch length; sentences accumulate per stream across ``append``
    calls exactly as in the reference.

    Example
    -------
    >>> bleu = BLEUStats()
    >>> i2l = {0: 'a', 1: 'b'}
    >>> bleu.append(
    ...     ids=['utterance1'],
    ...     predict=[[0, 1, 1]],
    ...     targets=[[[0, 1, 0]], [[0, 1, 1]], [[1, 1, 0]]],
    ...     ind2lab=lambda batch: [[i2l[int(x)] for x in seq]
    ...                            for seq in batch],
    ... )
    >>> stats = bleu.summarize()
    >>> stats['BLEU']
    0.0
    """

    def __init__(self, lang="en", merge_words=True):
        self.merge_words = merge_words
        self.clear()

    def clear(self):
        self.ids = []
        self.predicts = []
        self.targets = None
        self.scores = None
        self.summary = {}

    def append(self, ids, predict, targets, ind2lab=None):
        self.ids.extend(ids)
        if ind2lab is not None:
            predict, targets = ind2lab(predict), [ind2lab(t)
                                                  for t in targets]
        if self.merge_words:
            predict, targets = merge_words(predict), [merge_words(t)
                                                      for t in targets]
        self.predicts.extend(predict)
        if self.targets is None:
            self.targets = targets
        else:
            assert len(self.targets) == len(targets)
            for seen, new in zip(self.targets, targets):
                seen.extend(new)

    def summarize(self, field=None):
        try:
            import sacrebleu
        except ImportError:
            sacrebleu = None
        if sacrebleu is not None:
            scores = sacrebleu.corpus_bleu(self.predicts, self.targets)
            details = {
                "BLEU": scores.score,
                "BP": scores.bp,
                "ratio": scores.sys_len / scores.ref_len,
                "hyp_len": scores.sys_len,
                "ref_len": scores.ref_len,
                "precisions": scores.precisions,
            }
            self.scores = scores
        else:
            hyps = [p.split() if isinstance(p, str) else p
                    for p in self.predicts]
            refs = [[t.split() if isinstance(t, str) else t for t in ref]
                    for ref in zip(*self.targets)] if self.targets else []
            details = {"BLEU": corpus_bleu(hyps, refs)}
            self.scores = details["BLEU"]
        self.summary = details
        self.summary["bleu_score"] = self.summary["BLEU"]
        if field is not None:
            return self.summary[field]
        return self.summary

    def write_stats(self, filestream):
        if not self.summary:
            self.summarize()
        print(self.scores, file=filestream)
