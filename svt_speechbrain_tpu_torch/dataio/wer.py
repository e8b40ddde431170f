"""WER output formatting (a copy of ``svt_speechbrain_tpu/dataio/wer.py``):
Kaldi-style summary and per-utterance alignment printing, the same text as
the JAX package's."""
from __future__ import annotations

import sys

from svt_speechbrain_tpu_torch.utils import edit_distance


def print_wer_summary(wer_details, file=None):
    """Kaldi compute-wer-style summary (reference ``wer.py:15``).

    Example
    -------
    >>> from svt_speechbrain_tpu.utils.edit_distance import (
    ...     wer_details_for_batch, wer_summary)
    >>> details = wer_details_for_batch(["u1"], [["a", "b"]], [["a", "c"]])
    >>> print_wer_summary(wer_summary(details))
    %WER 50.00 [ 1 / 2, 0 ins, 0 del, 1 sub ]
    %SER 100.00 [ 1 / 1 ]
    Scored 1 sentences, 0 not present in hyp.
    """
    file = file or sys.stdout
    print(
        "%WER {WER:.2f} [ {num_edits} / {num_scored_tokens}, {insertions} "
        "ins, {deletions} del, {substitutions} sub ]".format(**wer_details),
        file=file, end="")
    print(" [PARTIAL]"
          if wer_details["num_scored_sents"] < wer_details["num_ref_sents"]
          else "", file=file)
    print("%SER {SER:.2f} [ {num_erraneous_sents} / {num_scored_sents} ]"
          .format(**wer_details), file=file)
    print("Scored {num_scored_sents} sentences, {num_absent_sents} not "
          "present in hyp.".format(**wer_details), file=file)


def print_alignments(details_by_utterance, file=None, empty_symbol="<eps>",
                     separator=" ; "):
    """Global format header + per-utterance aligned ref/op/hyp rows
    (reference ``wer.py:55``)."""
    file = file or sys.stdout
    _print_alignments_global_header(file=file, empty_symbol=empty_symbol,
                                    separator=separator)
    for dets in details_by_utterance:
        if dets["scored"]:
            _print_alignment_header(dets, file=file)
            _print_alignment(dets["alignment"], dets["ref_tokens"],
                             dets["hyp_tokens"], file=file,
                             empty_symbol=empty_symbol, separator=separator)


def _print_top_wer_utts(top_non_empty, top_empty, file=None):
    """Diagnostic top-K utterance listing (reference ``wer.py:96``)."""
    file = file or sys.stdout
    print("=" * 80, file=file)
    print("UTTERANCES WITH HIGHEST WER", file=file)
    if top_non_empty:
        print("Non-empty hypotheses -- utterances for which output was "
              "produced:", file=file)
        for dets in top_non_empty:
            print("{key} %WER {WER:.2f}".format(**dets), file=file)
    else:
        print("No utterances which had produced output!", file=file)
    if top_empty:
        print("Empty hypotheses -- utterances for which no output was "
              "produced:", file=file)
        for dets in top_empty:
            print("{key} %WER {WER:.2f}".format(**dets), file=file)
    else:
        print("No utterances which had not produced output!", file=file)


def _print_top_wer_spks(spks_by_wer, file=None):
    """Diagnostic top-K speaker listing (reference ``wer.py:119``)."""
    file = file or sys.stdout
    print("=" * 80, file=file)
    print("SPEAKERS WITH HIGHEST WER", file=file)
    for dets in spks_by_wer:
        print("{speaker} %WER {WER:.2f}".format(**dets), file=file)


def _print_alignment(alignment, a, b, empty_symbol="<eps>", separator=" ; ",
                     file=None):
    file = file or sys.stdout
    a_padded, b_padded, ops_padded = [], [], []
    for op, i, j in alignment:
        op_string = str(op)
        a_string = str(a[i]) if i is not None else empty_symbol
        b_string = str(b[j]) if j is not None else empty_symbol
        pad_length = max(len(op_string), len(a_string), len(b_string))
        a_padded.append(a_string.center(pad_length))
        b_padded.append(b_string.center(pad_length))
        ops_padded.append(op_string.center(pad_length))
    print(separator.join(a_padded), file=file)
    print(separator.join(ops_padded), file=file)
    print(separator.join(b_padded), file=file)


def _print_alignments_global_header(empty_symbol="<eps>", separator=" ; ",
                                    file=None):
    file = file or sys.stdout
    print("=" * 80, file=file)
    print("ALIGNMENTS", file=file)
    print("", file=file)
    print("Format:", file=file)
    print("<utterance-id>, WER DETAILS", file=file)
    a = ["reference", "on", "the", "first", "line"]
    b = ["and", "hypothesis", "on", "the", "third"]
    alignment = [
        (edit_distance.EDIT_SYMBOLS["ins"], None, 0),
        (edit_distance.EDIT_SYMBOLS["sub"], 0, 1),
        (edit_distance.EDIT_SYMBOLS["eq"], 1, 2),
        (edit_distance.EDIT_SYMBOLS["eq"], 2, 3),
        (edit_distance.EDIT_SYMBOLS["sub"], 3, 4),
        (edit_distance.EDIT_SYMBOLS["del"], 4, None),
    ]
    _print_alignment(alignment, a, b, file=file, empty_symbol=empty_symbol,
                     separator=separator)


def _print_alignment_header(wer_details, file=None):
    file = file or sys.stdout
    print("=" * 80, file=file)
    print(
        "{key}, %WER {WER:.2f} [ {num_edits} / {num_ref_tokens}, "
        "{insertions} ins, {deletions} del, {substitutions} sub ]".format(
            **wer_details), file=file)
