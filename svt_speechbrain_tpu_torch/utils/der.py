"""Diarization error rate (analogue of reference ``speechbrain/utils/DER.py``;
a copy of ``svt_speechbrain_tpu/utils/der.py``).

The reference shells out to NIST md-eval.pl; this is a self-contained DER
over RTTM-style segment lists with an optional forgiveness collar.
"""
from __future__ import annotations

import numpy as np


def _segments_to_frames(segments, frame=0.01, total=None):
    """[(start, end, label)] → per-frame label sets."""
    end_t = total or max((e for _, e, _ in segments), default=0.0)
    n = int(round(end_t / frame)) + 1
    frames = [set() for _ in range(n)]
    for start, end, label in segments:
        for i in range(int(round(start / frame)), min(int(round(end / frame)), n)):
            frames[i].add(label)
    return frames


def DER(ref_segments, sys_segments, collar=0.25, frame=0.01):
    """Diarization error rate = (miss + false alarm + speaker confusion) /
    total reference speaker time. Segments: [(start_s, end_s, speaker)].

    The collar excises ±collar seconds around every reference boundary, like
    md-eval's -c option.

    Example
    -------
    >>> ref = [(0.0, 4.0, "A"), (4.0, 8.0, "B")]
    >>> DER(ref, ref)                  # perfect system
    0.0
    >>> sys = [(0.0, 8.0, "A")]        # misses speaker B entirely
    >>> round(DER(ref, sys, collar=0.0), 1)
    50.0
    """
    total = max(max((e for _, e, _ in ref_segments), default=0.0),
                max((e for _, e, _ in sys_segments), default=0.0))
    ref_frames = _segments_to_frames(ref_segments, frame, total)
    sys_frames = _segments_to_frames(sys_segments, frame, total)

    # collar mask
    scored = np.ones(len(ref_frames), dtype=bool)
    for start, end, _ in ref_segments:
        for boundary in (start, end):
            lo = int(round((boundary - collar) / frame))
            hi = int(round((boundary + collar) / frame))
            scored[max(lo, 0):min(hi, len(scored))] = False

    # greedy one-to-one speaker mapping by overlap
    overlap = {}
    for i in np.flatnonzero(scored):
        for r in ref_frames[i]:
            for s in sys_frames[i]:
                overlap[(r, s)] = overlap.get((r, s), 0) + 1
    mapping = {}
    used_sys = set()
    for (r, s), _ in sorted(overlap.items(), key=lambda kv: -kv[1]):
        if r not in mapping and s not in used_sys:
            mapping[r] = s
            used_sys.add(s)

    miss = fa = conf = ref_time = 0
    for i in np.flatnonzero(scored):
        refs, syss = ref_frames[i], sys_frames[i]
        ref_time += len(refs)
        n_ref, n_sys = len(refs), len(syss)
        correct = sum(1 for r in refs if mapping.get(r) in syss)
        miss += max(n_ref - n_sys, 0)
        fa += max(n_sys - n_ref, 0)
        conf += min(n_ref, n_sys) - correct
    if ref_time == 0:
        return 0.0
    return 100.0 * (miss + fa + conf) / ref_time


def rectify(arr):
    """Corner-case cleanup + percentage conversion (reference ``DER.py:24``):
    NaN (0/0) → 0, inf (x/0) → 1, then ×100."""
    import numpy as np

    arr = np.asarray(arr, dtype=np.float64)
    arr[np.isnan(arr)] = 0
    arr[np.isinf(arr)] = 1
    return arr * 100.0
