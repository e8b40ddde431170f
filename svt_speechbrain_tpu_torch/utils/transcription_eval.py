"""Note-transcription scoring — a self-contained, mir_eval-compatible scorer.

The reference scores song-level note predictions with
``mir_eval.transcription.evaluate`` (``MIR_ST500/train_audio_ssl.py:123-134``)
using onset tolerance 50 ms and pitch tolerance 50 cents
(``hparams/train_audio_ssl.yaml:51-54``). mir_eval is not vendored here;
this module reimplements the exact metric definitions:

- a (ref, est) note pair *matches* when
  * onset:  |est_on - ref_on| <= onset_tolerance,
  * pitch:  |1200 * log2(est_p / ref_p)| <= pitch_tolerance (cents),
  * offset: |est_off - ref_off| <= max(offset_min_tolerance,
            offset_ratio * ref_duration)     (only when offset_ratio given);
- the reported match count is a *maximum bipartite matching* over the pair
  graph (mir_eval uses Hopcroft-Karp; we use scipy's
  ``maximum_bipartite_matching``);
- COnPOff = all three conditions, COnP = onset+pitch (offset_ratio=None),
  COn = onset only, COff = offset only.

Returned dict keys mirror ``mir_eval.transcription.evaluate``.
"""
from __future__ import annotations

import numpy as np
from scipy.sparse import csr_matrix
from scipy.sparse.csgraph import maximum_bipartite_matching


def midi_to_hz(midi):
    """MIDI note number → frequency in Hz (mir_eval ``util.midi_to_hz``)."""
    return 440.0 * (2.0 ** ((np.asarray(midi, dtype=np.float64) - 69.0) / 12.0))


def validate_intervals(intervals, pitches):
    intervals = np.atleast_2d(np.asarray(intervals, dtype=np.float64))
    pitches = np.asarray(pitches, dtype=np.float64).reshape(-1)
    if intervals.size == 0:
        intervals = intervals.reshape(0, 2)
    if intervals.shape[0] != pitches.shape[0]:
        raise ValueError("intervals and pitches have mismatched lengths")
    if intervals.size and (intervals[:, 1] < intervals[:, 0]).any():
        raise ValueError("intervals must have non-negative duration")
    return intervals, pitches


def _max_matching(n_ref, n_est, pairs):
    """Maximum bipartite matching given allowed (ref, est) pairs.

    Returns the list of matched (ref, est) index pairs (maximum cardinality).
    """
    if not pairs:
        return []
    rows = np.array([p[0] for p in pairs])
    cols = np.array([p[1] for p in pairs])
    graph = csr_matrix((np.ones(len(pairs), dtype=np.int8), (rows, cols)),
                       shape=(n_ref, n_est))
    match = maximum_bipartite_matching(graph, perm_type="column")
    return [(i, int(match[i])) for i in range(n_ref) if match[i] >= 0]


def _match_pairs(ref_intervals, ref_pitches, est_intervals, est_pitches,
                 onset_tolerance=0.05, pitch_tolerance=50.0, offset_ratio=0.2,
                 offset_min_tolerance=0.05, strict=False,
                 with_onset=True, with_pitch=True, with_offset=True):
    """Enumerate allowed (ref, est) index pairs under the selected conditions."""
    cmp = np.less if strict else np.less_equal
    n_ref, n_est = len(ref_pitches), len(est_pitches)
    if n_ref == 0 or n_est == 0:
        return [], n_ref, n_est

    ok = np.ones((n_ref, n_est), dtype=bool)
    if with_onset:
        onset_dist = np.abs(ref_intervals[:, 0:1] - est_intervals[None, :, 0])
        ok &= cmp(onset_dist, onset_tolerance)
    if with_pitch:
        cents = np.abs(1200.0 * np.log2(est_pitches[None, :] / ref_pitches[:, None]))
        ok &= cmp(cents, pitch_tolerance)
    if with_offset:
        ref_dur = ref_intervals[:, 1] - ref_intervals[:, 0]
        tol = np.maximum(offset_min_tolerance, offset_ratio * ref_dur)[:, None]
        offset_dist = np.abs(ref_intervals[:, 1:2] - est_intervals[None, :, 1])
        ok &= cmp(offset_dist, tol)
    idx = np.argwhere(ok)
    return [tuple(p) for p in idx], n_ref, n_est


def _prf(n_matched, n_ref, n_est, beta=1.0):
    precision = n_matched / n_est if n_est else 0.0
    recall = n_matched / n_ref if n_ref else 0.0
    if precision + recall > 0:
        f = (1 + beta ** 2) * precision * recall / (beta ** 2 * precision + recall)
    else:
        f = 0.0
    return precision, recall, f


def precision_recall_f1_overlap(ref_intervals, ref_pitches, est_intervals, est_pitches,
                                onset_tolerance=0.05, pitch_tolerance=50.0,
                                offset_ratio=0.2, offset_min_tolerance=0.05,
                                strict=False, beta=1.0):
    """COnPOff (or COnP when ``offset_ratio=None``) precision/recall/F."""
    ref_intervals, ref_pitches = validate_intervals(ref_intervals, ref_pitches)
    est_intervals, est_pitches = validate_intervals(est_intervals, est_pitches)
    pairs, n_ref, n_est = _match_pairs(
        ref_intervals, ref_pitches, est_intervals, est_pitches,
        onset_tolerance, pitch_tolerance, offset_ratio or 0.0, offset_min_tolerance,
        strict, with_onset=True, with_pitch=True, with_offset=offset_ratio is not None,
    )
    matching = _max_matching(n_ref, n_est, pairs)
    p, r, f = _prf(len(matching), n_ref, n_est, beta)
    return p, r, f, average_overlap_ratio(ref_intervals, est_intervals, matching)


def onset_precision_recall_f1(ref_intervals, est_intervals, onset_tolerance=0.05,
                              strict=False, beta=1.0):
    """COn precision/recall/F (onset-only matching)."""
    ref_intervals = np.atleast_2d(np.asarray(ref_intervals, dtype=np.float64))
    est_intervals = np.atleast_2d(np.asarray(est_intervals, dtype=np.float64))
    dummy_ref = np.ones(len(ref_intervals))
    dummy_est = np.ones(len(est_intervals))
    pairs, n_ref, n_est = _match_pairs(
        ref_intervals, dummy_ref, est_intervals, dummy_est,
        onset_tolerance, 0.0, 0.0, 0.0, strict,
        with_onset=True, with_pitch=False, with_offset=False,
    )
    matching = _max_matching(n_ref, n_est, pairs)
    return _prf(len(matching), n_ref, n_est, beta)


def offset_precision_recall_f1(ref_intervals, est_intervals, offset_ratio=0.2,
                               offset_min_tolerance=0.05, strict=False, beta=1.0):
    """COff precision/recall/F (offset-only matching)."""
    ref_intervals = np.atleast_2d(np.asarray(ref_intervals, dtype=np.float64))
    est_intervals = np.atleast_2d(np.asarray(est_intervals, dtype=np.float64))
    dummy_ref = np.ones(len(ref_intervals))
    dummy_est = np.ones(len(est_intervals))
    pairs, n_ref, n_est = _match_pairs(
        ref_intervals, dummy_ref, est_intervals, dummy_est,
        0.0, 0.0, offset_ratio, offset_min_tolerance, strict,
        with_onset=False, with_pitch=False, with_offset=True,
    )
    matching = _max_matching(n_ref, n_est, pairs)
    return _prf(len(matching), n_ref, n_est, beta)


def average_overlap_ratio(ref_intervals, est_intervals, matching):
    """Mean IoU over matched (ref, est) interval pairs (mir_eval's
    ``average_overlap_ratio``)."""
    if not matching:
        return 0.0
    ratios = []
    for r, e in matching:
        union = max(ref_intervals[r, 1], est_intervals[e, 1]) - min(ref_intervals[r, 0], est_intervals[e, 0])
        inter = min(ref_intervals[r, 1], est_intervals[e, 1]) - max(ref_intervals[r, 0], est_intervals[e, 0])
        ratios.append(inter / union if union > 0 else 0.0)
    return float(np.mean(ratios))


def evaluate(ref_intervals, ref_pitches, est_intervals, est_pitches,
             onset_tolerance=0.05, pitch_tolerance=50.0, offset_ratio=0.2,
             offset_min_tolerance=0.05, strict=False, beta=1.0):
    """Full scoring dict mirroring ``mir_eval.transcription.evaluate``.

    Example
    -------
    >>> import numpy as np
    >>> ref = np.asarray([[0.0, 1.0], [1.5, 2.0]])
    >>> pitches = np.asarray([440.0, 880.0])
    >>> est = np.asarray([[0.01, 0.98], [1.51, 2.05]])
    >>> scores = evaluate(ref, pitches, est, pitches)
    >>> scores["F-measure"], scores["Onset_F-measure"]
    (1.0, 1.0)
    >>> bad = evaluate(ref, pitches, est, np.asarray([440.0, 440.0]))
    >>> round(bad["F-measure"], 2)      # one wrong pitch
    0.5
    """
    ref_intervals, ref_pitches = validate_intervals(ref_intervals, ref_pitches)
    est_intervals, est_pitches = validate_intervals(est_intervals, est_pitches)
    scores = {}
    p, r, f, aor = precision_recall_f1_overlap(
        ref_intervals, ref_pitches, est_intervals, est_pitches,
        onset_tolerance, pitch_tolerance, offset_ratio, offset_min_tolerance, strict, beta)
    scores["Precision"], scores["Recall"], scores["F-measure"] = p, r, f
    # mir_eval also reports the mean matched-interval IoU; its value depends
    # on WHICH maximum matching the matcher picked (ties exist), so parity is
    # "achievable by some maximum matching", tested differentially
    scores["Average_Overlap_Ratio"] = aor
    p, r, f, aor = precision_recall_f1_overlap(
        ref_intervals, ref_pitches, est_intervals, est_pitches,
        onset_tolerance, pitch_tolerance, None, offset_min_tolerance, strict, beta)
    scores["Precision_no_offset"], scores["Recall_no_offset"], scores["F-measure_no_offset"] = p, r, f
    scores["Average_Overlap_Ratio_no_offset"] = aor
    p, r, f = onset_precision_recall_f1(ref_intervals, est_intervals, onset_tolerance, strict, beta)
    scores["Onset_Precision"], scores["Onset_Recall"], scores["Onset_F-measure"] = p, r, f
    p, r, f = offset_precision_recall_f1(ref_intervals, est_intervals, offset_ratio,
                                         offset_min_tolerance, strict, beta)
    scores["Offset_Precision"], scores["Offset_Recall"], scores["Offset_F-measure"] = p, r, f
    return scores
