"""AMT label/decode library (numpy only): a copy of
``svt_speechbrain_tpu/utils/amt.py`` — ``note2frame``, ``onset_peaks``,
``frame2note`` and ``frame2note_fast`` with their constants — kept in the
port because importing the JAX package's module imports JAX.

Label format per frame: ``[onset, silence, octave, pitch_class]`` with
``octave ∈ 0..4`` (4 = none) and ``pitch_class ∈ 0..12`` (12 = none); pitch
range C2..B5 = MIDI 36..83.
"""
from __future__ import annotations

import numpy as np

OCTAVE_START = 0
OCTAVE_END = 3
PITCH_CLASS_NUM = 12
MIDI_BASE = 36  # C2


def _octave_and_class(midi_pitch):
    """Clamped octave index (0..3) and pitch class (0..11) for a MIDI pitch."""
    octave = int(min(max(OCTAVE_START, (midi_pitch - MIDI_BASE) // PITCH_CLASS_NUM), OCTAVE_END)) - OCTAVE_START
    pitch_class = midi_pitch % PITCH_CLASS_NUM
    return octave, pitch_class


def note2frame(gt_data, length, frame_size=1 / 49.8, pitch_shift=0):
    """Convert note events ``[[onset_s, offset_s, midi], ...]`` to per-frame
    labels of shape (length, 4). Reference: ``MIR_ST500/utils.py:10-79``.

    Semantics reproduced exactly:
    - a frame within ±frame_size/2 of the current note's onset is an onset
      frame (``[1, 0, oct, cls]``), except when the previous emitted frame was
      already an onset (then ``[0, 0, oct, cls]``);
    - frames before the current note's onset (or after all notes) are silence
      ``[0, 1, 4, 12]``;
    - a frame within ±frame_size/2 of the offset emits ``[0, 1, oct, cls]``
      and advances to the next note — unless the next note's onset also falls
      in this frame, in which case the frame becomes that note's onset;
    - other frames inside a note are voiced ``[0, 0, oct, cls]``.

    Example
    -------
    >>> labels = note2frame([[0.0, 0.06, 60]], length=6, frame_size=0.02)
    >>> labels.shape                       # [onset, silence, octave, class]
    (6, 4)
    >>> labels[0].tolist()                 # MIDI 60 = C4: octave 2, class 0
    [1, 0, 2, 0]
    >>> labels[:, 1].tolist()              # offset at t=0.06, then silence
    [0, 0, 0, 1, 1, 1]
    """
    labels = []
    cur_note = 0
    cur_onset = gt_data[cur_note][0]
    cur_offset = gt_data[cur_note][1]
    cur_pitch = gt_data[cur_note][2] + pitch_shift
    half = frame_size / 2.0

    for i in range(length):
        t = i * frame_size

        if abs(t - cur_onset) <= half:
            octv, cls = _octave_and_class(cur_pitch)
            onset_flag = 1 if (i == 0 or labels[-1][0] != 1) else 0
            labels.append([onset_flag, 0, octv, cls])
        elif t < cur_onset or cur_note >= len(gt_data):
            labels.append([0, 1, OCTAVE_END + 1, PITCH_CLASS_NUM])
        elif abs(t - cur_offset) <= half:
            octv, cls = _octave_and_class(cur_pitch)
            label = [0, 1, octv, cls]
            cur_note += 1
            if cur_note < len(gt_data):
                cur_onset = gt_data[cur_note][0]
                cur_offset = gt_data[cur_note][1]
                cur_pitch = gt_data[cur_note][2] + pitch_shift
                if abs(t - cur_onset) <= half:
                    octv, cls = _octave_and_class(cur_pitch)
                    label = [1, 0, octv, cls]
            labels.append(label)
        else:
            octv, cls = _octave_and_class(cur_pitch)
            labels.append([0, 0, octv, cls])

    return np.array(labels)


def onset_peaks(onset_probs, onset_thres, local_max_size=3):
    """Vectorized onset peak-picking mask.

    A frame ``i`` is a peak iff ``onset_probs[i] >= thres`` and it equals the
    max of ``onset_probs[max(0, i-3) : min(i+4, n-1)]`` — including the
    reference's quirk that the window's forward edge is clamped to ``n-1``
    (exclusive), so the final frame is compared against a window that does not
    contain itself (``MIR_ST500/utils.py:106-115``).
    """
    onset_probs = np.asarray(onset_probs, dtype=np.float64)
    n = len(onset_probs)
    peaks = np.zeros(n, dtype=bool)
    if n == 0:
        return peaks
    # vectorized sliding max: 2k+1 shifted-maximum passes instead of a
    # per-frame python loop (the stitcher decodes ~50 frames per audio
    # second, so this runs at full pipeline RTFx)
    k = local_max_size
    wmax = np.full(n, -np.inf)
    for d in range(-k, k + 1):
        # window indices i+d must fall in [0, n-2] (the n-1 clamp quirk)
        lo = max(0, -d)
        hi = min(n, (n - 1) - d)
        if hi > lo:
            np.maximum(wmax[lo:hi], onset_probs[lo + d:hi + d],
                       out=wmax[lo:hi])
    # empty windows (wmax still -inf) are never peaks
    return (onset_probs >= onset_thres) & (onset_probs == wmax)


def frame2note(frame_info, onset_thres, offset_thres, frame_size=1 / 49.8):
    """Decode per-frame predictions into note events ``[on_s, off_s, midi]``.

    Reference: ``MIR_ST500/utils.py:82-149``. ``frame_info`` is a sequence of
    ``(onset_prob, offset_prob, octave_idx, pitch_class_idx)`` tuples.

    State machine (reproduced exactly):
    - an onset peak closes any open note (emitting it with the majority-vote
      pitch) and opens a new one at the current time;
    - otherwise ``offset_prob >= offset_thres`` closes the open note;
    - while a note is open, each frame votes ``octave*12 + class`` unless the
      octave is the none-bin (4) or the class is the none-bin (12);
    - notes with no votes are dropped; an open note at the end is closed at
      the final frame time.

    Example
    -------
    >>> import numpy as np
    >>> frames = np.asarray([
    ...     [0.9, 0.0, 2, 0],      # onset peak, votes C4 (2*12+0+36=60)
    ...     [0.1, 0.0, 2, 0],
    ...     [0.1, 0.9, 2, 0],      # offset fires
    ...     [0.1, 0.0, 4, 12],     # silence (none-bins)
    ... ], dtype=np.float64)
    >>> notes = frame2note(frames, onset_thres=0.5, offset_thres=0.5,
    ...                    frame_size=0.02)
    >>> [[round(v, 2) for v in n] for n in notes]
    [[0.0, 0.04, 60]]
    """
    n = len(frame_info)
    if isinstance(frame_info, np.ndarray):
        onset_seq = np.asarray(frame_info[:, 0], dtype=np.float64)
    else:
        onset_seq = np.array([frame_info[i][0] for i in range(n)], dtype=np.float64)
    peaks = onset_peaks(onset_seq, onset_thres)

    result = []
    current_onset = None
    pitch_counter = []
    current_time = 0.0

    for i in range(n):
        current_time = frame_size * i
        info = frame_info[i]

        if peaks[i]:
            if current_onset is not None and len(pitch_counter) > 0:
                result.append([current_onset, current_time,
                               max(set(pitch_counter), key=pitch_counter.count) + MIDI_BASE])
            current_onset = current_time
            pitch_counter = []
        elif info[1] >= offset_thres:
            if current_onset is not None:
                if len(pitch_counter) > 0:
                    result.append([current_onset, current_time,
                                   max(set(pitch_counter), key=pitch_counter.count) + MIDI_BASE])
                current_onset = None
                pitch_counter = []

        if current_onset is not None:
            final_pitch = int(info[2] * 12 + info[3])
            if info[2] != OCTAVE_END + 1 and info[3] != PITCH_CLASS_NUM:
                pitch_counter.append(final_pitch)

    if current_onset is not None and len(pitch_counter) > 0:
        result.append([current_onset, current_time,
                       max(set(pitch_counter), key=pitch_counter.count) + MIDI_BASE])

    return result


def frame2note_fast(frame_info, onset_thres, offset_thres, frame_size=1 / 49.8):
    """Vectorized ``frame2note`` for the batched inference path.

    BIT-IDENTICAL to ``frame2note`` (equivalence-tested including vote
    ties): peak/offset/segment extraction is vectorized numpy; the
    per-note majority vote — a few dozen elements — uses the exact
    decoder's ``max(set(votes), key=votes.count)`` expression so even
    CPython set-iteration tie-breaking matches.
    """
    arr = np.asarray(frame_info, dtype=np.float64)
    n = len(arr)
    if n == 0:
        return []
    onset_seq = arr[:, 0]
    peaks = onset_peaks(onset_seq, onset_thres)
    offsets = (arr[:, 1] >= offset_thres) & ~peaks
    votes_ok = (arr[:, 2] != OCTAVE_END + 1) & (arr[:, 3] != PITCH_CLASS_NUM)
    pitches = (arr[:, 2] * 12 + arr[:, 3]).astype(np.int64)

    peak_idx = np.flatnonzero(peaks)
    if len(peak_idx) == 0:
        return []
    event_idx = np.flatnonzero(peaks | offsets)
    result = []
    for start in peak_idx:
        # segment ends at the next peak-or-offset event, else end of sequence
        pos = np.searchsorted(event_idx, start + 1)
        end = event_idx[pos] if pos < len(event_idx) else None
        seg_end = end if end is not None else n
        seg_votes = pitches[start:seg_end][votes_ok[start:seg_end]].tolist()
        if len(seg_votes) == 0:
            continue
        pitch = max(set(seg_votes), key=seg_votes.count)
        close_time = (end if end is not None else n - 1) * frame_size
        result.append([start * frame_size, close_time, pitch + MIDI_BASE])
    return result


def frame2note_finegrain(frame_info, onset_thres, offset_thres, octave_class_num=4,
                         pitch_class_num=12, frame_size=1 / 49.8):
    """Fine-grained variant (reference ``MIR_ST500/utils.py:152-219``): pitch
    votes are floats ``octave*12 + class * 12/pitch_class_num``, allowing a
    finer pitch grid."""
    n = len(frame_info)
    onset_seq = np.array([frame_info[i][0] for i in range(n)], dtype=np.float64)
    peaks = onset_peaks(onset_seq, onset_thres)

    result = []
    current_onset = None
    pitch_counter = []
    current_time = 0.0

    for i in range(n):
        current_time = frame_size * i
        info = frame_info[i]

        if peaks[i]:
            if current_onset is not None and len(pitch_counter) > 0:
                result.append([current_onset, current_time,
                               max(set(pitch_counter), key=pitch_counter.count) + MIDI_BASE])
            current_onset = current_time
            pitch_counter = []
        elif info[1] >= offset_thres:
            if current_onset is not None:
                if len(pitch_counter) > 0:
                    result.append([current_onset, current_time,
                                   max(set(pitch_counter), key=pitch_counter.count) + MIDI_BASE])
                current_onset = None
                pitch_counter = []

        if current_onset is not None:
            final_pitch = float(info[2] * 12 + info[3] * 12 / pitch_class_num)
            if info[2] != octave_class_num and info[3] != pitch_class_num:
                pitch_counter.append(final_pitch)

    if current_onset is not None and len(pitch_counter) > 0:
        result.append([current_onset, current_time,
                       max(set(pitch_counter), key=pitch_counter.count) + MIDI_BASE])

    return result


class AverageMeter:
    """Running average (reference ``MIR_ST500/utils.py:222-238``)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0
        self.avg = 0
        self.sum = 0
        self.count = 0

    def update(self, val, n=1):
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / self.count


class IncrementalFrame2Note:
    """Streaming ``frame2note``: ``feed()`` frame predictions in arbitrary-size
    pieces and receive notes as soon as they are final; ``flush()`` at
    end-of-stream. The emitted note sequence is exactly
    ``frame2note(all_frames)`` — including the reference's end-clamped peak
    window quirk, which is why a frame's onset-peak decision only becomes
    final once ``local_max_size + 1`` further frames have arrived (or the
    stream ends). Memory is O(window), not O(song).
    """

    def __init__(self, onset_thres, offset_thres, frame_size=1 / 49.8,
                 local_max_size=3):
        self.onset_thres = float(onset_thres)
        self.offset_thres = float(offset_thres)
        self.frame_size = frame_size
        self.k = local_max_size
        self._pending = []     # frame tuples with global index _base + pos
        self._probs = []       # onset probs aligned with _pending
        self._hist = []        # up to k onset probs just before _base
        self._base = 0
        self._received = 0
        self._current_onset = None
        self._pitch_counter = []
        self._last_time = 0.0

    def _window_max(self, i, hi):
        """max of onset probs over global [max(i-k, 0), hi) from hist+pending."""
        lo = max(i - self.k, 0)
        vals = []
        for g in range(lo, hi):
            if g < self._base:
                vals.append(self._hist[g - self._base])  # negative index into hist
            else:
                vals.append(self._probs[g - self._base])
        return max(vals) if vals else None

    def _step(self, i, info, is_peak, out):
        t = self.frame_size * i
        self._last_time = t
        if is_peak:
            if self._current_onset is not None and len(self._pitch_counter) > 0:
                out.append([self._current_onset, t,
                            max(set(self._pitch_counter),
                                key=self._pitch_counter.count) + MIDI_BASE])
            self._current_onset = t
            self._pitch_counter = []
        elif info[1] >= self.offset_thres:
            if self._current_onset is not None:
                if len(self._pitch_counter) > 0:
                    out.append([self._current_onset, t,
                                max(set(self._pitch_counter),
                                    key=self._pitch_counter.count) + MIDI_BASE])
                self._current_onset = None
                self._pitch_counter = []
        if self._current_onset is not None:
            if info[2] != OCTAVE_END + 1 and info[3] != PITCH_CLASS_NUM:
                self._pitch_counter.append(int(info[2] * 12 + info[3]))

    def _advance(self, i, out):
        """Process the frame at global index ``i == self._base``."""
        prob = self._probs[0]
        info = self._pending[0]
        hi = i + self.k + 1  # no end clamp: caller guarantees n_final > hi
        wmax = self._window_max(i, hi)
        is_peak = prob >= self.onset_thres and prob == wmax
        self._step(i, info, is_peak, out)
        self._hist.append(prob)
        if len(self._hist) > self.k:
            self._hist.pop(0)
        self._pending.pop(0)
        self._probs.pop(0)
        self._base += 1

    def feed(self, frames):
        """Consume an iterable of (onset_prob, offset_prob, octave, class)
        rows; returns the list of notes finalized by this piece."""
        for row in np.asarray(frames, dtype=np.float64).reshape(-1, 4):
            self._pending.append(row)
            self._probs.append(float(row[0]))
            self._received += 1
        out = []
        # frame i's peak window [i-k, i+k+1) is final once received >= i+k+2
        while self._pending and self._received >= self._base + self.k + 2:
            self._advance(self._base, out)
        return out

    def flush(self):
        """End the stream: decode the tail with the final-length window clamp
        and emit any open note, exactly like ``frame2note``'s epilogue."""
        n = self._received
        out = []
        while self._pending:
            i = self._base
            prob = self._probs[0]
            info = self._pending[0]
            hi = min(i + self.k + 1, n - 1)
            wmax = self._window_max(i, hi)
            is_peak = (wmax is not None and prob >= self.onset_thres
                       and prob == wmax)
            self._step(i, info, is_peak, out)
            self._hist.append(prob)
            if len(self._hist) > self.k:
                self._hist.pop(0)
            self._pending.pop(0)
            self._probs.pop(0)
            self._base += 1
        if self._current_onset is not None and len(self._pitch_counter) > 0:
            out.append([self._current_onset, self._last_time,
                        max(set(self._pitch_counter),
                            key=self._pitch_counter.count) + MIDI_BASE])
        self._current_onset = None
        self._pitch_counter = []
        return out
