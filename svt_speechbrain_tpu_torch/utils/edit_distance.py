"""Edit-distance / WER utilities (a copy of
``svt_speechbrain_tpu/utils/edit_distance.py``). Host-side python — scoring
is off the device hot path.

Reference-exact (golden-tested in ``tests/test_edit_distance_golden.py``),
including the Kaldi compute-wer tie-breaking (ties prefer insertion >
deletion > substitution — so the op BREAKDOWN matches Kaldi, not just the
total edit distance), the sparse ``count_ops`` counters, the per-utterance
detail schema with its unscored placeholders, and ``top_wer_utts``'s
(non-empty, empty) pair. The implementation differs structurally from the
reference: the DP picks ops with one ordered ``min`` over candidate
tuples, and a single backtrack generator feeds both ``alignment`` and
``count_ops``.
"""
from __future__ import annotations

from collections import Counter

EDIT_SYMBOLS = {"eq": "=", "ins": "I", "del": "D", "sub": "S"}

_COUNTER_NAMES = {
    EDIT_SYMBOLS["ins"]: "insertions",
    EDIT_SYMBOLS["del"]: "deletions",
    EDIT_SYMBOLS["sub"]: "substitutions",
}
_ABSENT = object()


def accumulatable_wer_stats(refs, hyps, stats=None):
    """Accumulate WER counts over batches (reference ``edit_distance.py:20``):
    returns a Counter with WER/insertions/deletions/substitutions/
    num_ref_tokens; pass the result back in to accumulate.

    Example
    -------
    >>> stats = accumulatable_wer_stats([["a", "b", "c"]], [["a", "x", "c"]])
    >>> stats["substitutions"], round(stats["WER"], 2)
    (1, 33.33)
    >>> stats = accumulatable_wer_stats([["d"]], [["d"]], stats)  # accumulate
    >>> round(stats["WER"], 2)
    25.0
    """
    totals = (Counter() if stats is None else stats) + _tally(refs, hyps)
    edits = sum(totals[name] for name in _COUNTER_NAMES.values())
    denom = totals["num_ref_tokens"]
    totals["WER"] = 100.0 * edits / denom if denom else float("nan")
    return totals


def _tally(refs, hyps):
    """One batch's sparse op/token counts."""
    if len(refs) != len(hyps):
        raise ValueError(
            "The reference and hypothesis batches are not of the same size")
    counts = Counter(num_ref_tokens=sum(map(len, refs)))
    for ref_tokens, hyp_tokens in zip(refs, hyps):
        counts.update(count_ops(op_table(ref_tokens, hyp_tokens)))
    return counts


def op_table(a, b):
    """Edit-op table via dynamic programming (reference ``:122``).
    Returns a (len(a)+1, len(b)+1) table of EDIT_SYMBOLS, with the Kaldi
    compute-wer tie order (insertion > deletion > substitution) expressed
    as one ordered ``min`` over (cost, priority, symbol) candidates.

    Example
    -------
    >>> print(*op_table([1, 2, 3], [1, 2, 4]), sep="\\n")
    ['=', 'I', 'I', 'I']
    ['D', '=', 'I', 'I']
    ['D', 'D', '=', 'I']
    ['D', 'D', 'D', 'S']
    """
    width = len(b) + 1
    ops = [[EDIT_SYMBOLS["ins"]] * width]
    ops += [[EDIT_SYMBOLS["del"]] * width for _ in a]
    ops[0][0] = EDIT_SYMBOLS["eq"]
    above = list(range(width))
    for i, tok_a in enumerate(a, start=1):
        row = [i] + [0] * len(b)
        for j, tok_b in enumerate(b, start=1):
            mismatch = tok_a != tok_b
            row[j], _, ops[i][j] = min(
                (row[j - 1] + 1, 0, EDIT_SYMBOLS["ins"]),
                (above[j] + 1, 1, EDIT_SYMBOLS["del"]),
                (above[j - 1] + mismatch, 2,
                 EDIT_SYMBOLS["sub"] if mismatch else EDIT_SYMBOLS["eq"]))
        above = row
    return ops


def _walk(table):
    """Backtrack the op table from the far corner, yielding
    (op, ref_idx|None, hyp_idx|None) steps in REVERSE order."""
    i, j = len(table) - 1, len(table[0]) - 1
    while i or j:
        if j == 0:
            op = EDIT_SYMBOLS["del"]
        elif i == 0:
            op = EDIT_SYMBOLS["ins"]
        else:
            op = table[i][j]
        if op == EDIT_SYMBOLS["ins"]:
            j -= 1
            yield op, None, j
        elif op == EDIT_SYMBOLS["del"]:
            i -= 1
            yield op, i, None
        else:
            i, j = i - 1, j - 1
            yield op, i, j


def alignment(table):
    """Backtrace the op table → [(op, ref_idx|None, hyp_idx|None)]
    (reference ``:212``).

    Example
    -------
    >>> alignment(op_table("abc", "abx"))
    [('=', 0, 0), ('=', 1, 1), ('S', 2, 2)]
    """
    return list(_walk(table))[::-1]


def count_ops(table):
    """Count I/D/S along the shortest edit path (reference ``:275``);
    returns a sparse Counter (zero counts are absent keys, like the
    reference).

    Example
    -------
    >>> count_ops(op_table("abc", "abx"))
    Counter({'substitutions': 1})
    """
    return Counter(_COUNTER_NAMES[op] for op, _, _ in _walk(table)
                   if op in _COUNTER_NAMES)


def wer_details_for_batch(ids, refs, hyps, compute_alignments=False):
    """Convenient batch interface over ``wer_details_by_utterance``
    (reference ``:340``)."""
    return wer_details_by_utterance(dict(zip(ids, refs)),
                                    dict(zip(ids, hyps)),
                                    compute_alignments=compute_alignments,
                                    scoring_mode="strict")


def wer_details_by_utterance(ref_dict, hyp_dict, compute_alignments=False,
                             scoring_mode="strict"):
    """Per-utterance WER details from id → token-list dicts — the
    reference's exact schema incl. unscored placeholders (``:384``).
    ``scoring_mode``: "strict" raises on missing hyps, "present" skips
    them (keeping a placeholder entry), "all" scores them empty."""
    details_by_utterance = []
    for key, ref_tokens in ref_dict.items():
        hyp_tokens = hyp_dict.get(key, _ABSENT)
        entry = dict(
            key=key, scored=False, hyp_absent=hyp_tokens is _ABSENT,
            hyp_empty=None, num_edits=None,
            num_ref_tokens=len(ref_tokens), WER=None, insertions=None,
            deletions=None, substitutions=None, alignment=None,
            ref_tokens=ref_tokens if compute_alignments else None,
            hyp_tokens=None)
        if hyp_tokens is _ABSENT:
            if scoring_mode == "present":
                details_by_utterance.append(entry)
                continue
            if scoring_mode == "strict":
                raise KeyError("Key " + str(key) + " in reference but "
                               "missing in hypothesis and strict mode on.")
            if scoring_mode != "all":
                raise ValueError("Invalid scoring mode: " + scoring_mode)
            hyp_tokens = []
        table = op_table(ref_tokens, hyp_tokens)
        ops = count_ops(table)
        entry.update(
            scored=True, hyp_empty=len(hyp_tokens) == 0,
            num_edits=sum(ops.values()),
            WER=100.0 * sum(ops.values()) / len(ref_tokens),
            insertions=ops["insertions"], deletions=ops["deletions"],
            substitutions=ops["substitutions"],
            alignment=alignment(table) if compute_alignments else None,
            hyp_tokens=hyp_tokens if compute_alignments else None)
        details_by_utterance.append(entry)
    return details_by_utterance


def wer_summary(details_by_utterance):
    """Aggregate per-utterance details (reference ``:502``): WER/SER plus
    scored/absent/erraneous counts (the reference's spelling)."""
    scored = [d for d in details_by_utterance if d["scored"]]
    num_scored_tokens = sum(d["num_ref_tokens"] for d in scored)
    num_edits = sum(d["num_edits"] for d in scored)
    erraneous = sum(1 for d in scored if d["num_edits"] > 0)
    return {
        "WER": 100.0 * num_edits / num_scored_tokens,
        "SER": 100.0 * erraneous / len(scored),
        "num_edits": num_edits,
        "num_scored_tokens": num_scored_tokens,
        "num_erraneous_sents": erraneous,
        "num_scored_sents": len(scored),
        "num_absent_sents": sum(1 for d in details_by_utterance
                                if d["hyp_absent"]),
        "num_ref_sents": len(details_by_utterance),
        "insertions": sum(d["insertions"] for d in scored),
        "deletions": sum(d["deletions"] for d in scored),
        "substitutions": sum(d["substitutions"] for d in scored),
    }


def wer_details_by_speaker(details_by_utterance, utt2spk):
    """Group utterance details per speaker (reference ``:573``): returns a
    LIST of per-speaker dicts (keys speaker/insertions/dels/subs/…; WER and
    SER None for unscored speakers; ``num_ref_sents`` stays 0, a reference
    quirk kept for schema parity)."""
    grouped = {}
    for dets in details_by_utterance:
        tally = grouped.setdefault(utt2spk[dets["key"]], {
            "insertions": 0, "dels": 0, "subs": 0, "num_scored_tokens": 0,
            "num_scored_sents": 0, "num_edits": 0, "num_erraneous_sents": 0,
            "num_absent_sents": 0, "num_ref_sents": 0})
        tally["num_absent_sents"] += bool(dets["hyp_absent"])
        if dets["scored"]:
            tally["num_scored_sents"] += 1
            tally["num_scored_tokens"] += dets["num_ref_tokens"]
            tally["insertions"] += dets["insertions"]
            tally["dels"] += dets["deletions"]
            tally["subs"] += dets["substitutions"]
            tally["num_edits"] += dets["num_edits"]
            tally["num_erraneous_sents"] += dets["num_edits"] > 0
    details_by_speaker_dicts = []
    for speaker, tally in grouped.items():
        n_scored = tally["num_scored_sents"]
        tally["speaker"] = speaker
        tally["WER"] = (100.0 * tally["num_edits"]
                        / tally["num_scored_tokens"]) if n_scored else None
        tally["SER"] = (100.0 * tally["num_erraneous_sents"]
                        / n_scored) if n_scored else None
        details_by_speaker_dicts.append(tally)
    return details_by_speaker_dicts


def top_wer_utts(details_by_utterance, top_k=20):
    """Worst-WER utterances split into (non-empty, empty-hypothesis) lists
    (reference ``:666``)."""
    ranked = sorted((d for d in details_by_utterance if d["scored"]),
                    key=lambda d: d["WER"], reverse=True)
    top_non_empty = [d for d in ranked if not d["hyp_empty"]][:top_k]
    top_empty = [d for d in ranked if d["hyp_empty"]][:top_k]
    return top_non_empty, top_empty


def top_wer_spks(details_by_speaker, top_k=10):
    """Worst-WER speakers (reference ``:709``)."""
    ranked = sorted((d for d in details_by_speaker
                     if d["num_scored_sents"] > 0),
                    key=lambda d: d["WER"], reverse=True)
    return ranked[:top_k]
