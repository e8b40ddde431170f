"""The plain reference of the note decode: per-frame (onset probability,
offset probability, octave, pitch class) → note events [onset_s, offset_s,
midi], the state machine of the MIR-ST500 recipe's ``frame2note``
(``MIR_ST500/utils.py:82-149``, ported as
``svt_speechbrain_tpu_torch/utils/amt.py:117``), written as its loop.

Imports nothing of the program.
"""
from __future__ import annotations

NONE_OCTAVE, NONE_CLASS, MIDI_BASE = 4, 12, 36


def frame2note(frames, onset_thres, offset_thres, frame_size):
    """A frame opens a note where its onset probability reaches the
    threshold and equals the largest of ``onset[max(0, i-3):min(i+4, n-1)]``
    (the recipe's window, whose end is clamped to n - 1); otherwise an
    offset probability at its threshold closes the open note. An open note
    takes a vote ``octave * 12 + class`` from each frame not in a none-bin,
    is emitted with its most frequent vote (the recipe's
    ``max(set(votes), key=votes.count)``) and dropped without votes."""
    onset = [float(f[0]) for f in frames]
    n = len(frames)
    notes, start, votes, now = [], None, [], 0.0
    for i in range(n):
        now = frame_size * i
        window = onset[max(0, i - 3):min(i + 4, n - 1)]
        peak = onset[i] >= onset_thres and bool(window) and onset[i] == max(window)
        octave, cls = frames[i][2], frames[i][3]
        if peak:
            if start is not None and votes:
                notes.append([start, now, max(set(votes), key=votes.count)
                              + MIDI_BASE])
            start, votes = now, []
        elif frames[i][1] >= offset_thres and start is not None:
            if votes:
                notes.append([start, now, max(set(votes), key=votes.count)
                              + MIDI_BASE])
            start, votes = None, []
        if start is not None and octave != NONE_OCTAVE and cls != NONE_CLASS:
            votes.append(int(octave * 12 + cls))
    if start is not None and votes:
        notes.append([start, now, max(set(votes), key=votes.count) + MIDI_BASE])
    return notes
