"""CTC segmentation (port of
``svt_speechbrain_tpu/alignment/ctc_segmentation.py``): align a transcript
to long audio using CTC posteriors, yielding per-utterance time boundaries
and confidences (Kürzinger et al.). The dynamic programme is the JAX
package's numpy code, copied; ``CTCSegmentation`` runs the port's ASR
encoder on its device and reads its posteriors to the host once a call."""
from __future__ import annotations

import numpy as np
import torch


def ctc_segmentation(log_probs, tokens, blank_id=0, frame_duration=0.02,
                     min_window=8000):
    """log_probs (T, V) CTC posteriors; tokens: list of token-id lists per
    utterance. Returns list of (start_s, end_s, min_avg_logp) per utterance.

    Example
    -------
    >>> import numpy as np
    >>> lp = np.full((10, 3), -8.0)          # vocab: blank, tok1, tok2
    >>> lp[0:4, 1] = -0.1                    # frames 0-3 say tok1
    >>> lp[4:6, 0] = -0.1                    # frames 4-5 say blank
    >>> lp[6:10, 2] = -0.1                   # frames 6-9 say tok2
    >>> lp -= np.log(np.exp(lp).sum(1, keepdims=True))
    >>> segs = ctc_segmentation(lp, [[1], [2]], blank_id=0,
    ...                         frame_duration=0.02)
    >>> [(round(s, 2), round(e, 2)) for s, e, conf in segs]
    [(0.0, 0.08), (0.12, 0.18)]
    """
    log_probs = np.asarray(log_probs, dtype=np.float64)
    t_max = log_probs.shape[0]
    # build the interleaved blank/token CTC state sequence over the full text
    flat = []
    utter_bounds = []  # (state_start, state_end) per utterance
    for utt in tokens:
        start_state = 2 * len(flat)
        flat.extend(utt)
        utter_bounds.append((start_state, 2 * len(flat)))
    n_states = 2 * len(flat) + 1  # blanks interleaved

    def state_token(s):
        return blank_id if s % 2 == 0 else flat[s // 2]

    neg_inf = -1e30
    delta = np.full(n_states, neg_inf)
    delta[0] = log_probs[0, blank_id]
    if n_states > 1:
        delta[1] = log_probs[0, state_token(1)]
    backpointer_time = [np.zeros(n_states, dtype=np.int64)]
    entry_time = np.zeros(n_states, dtype=np.int64)

    for t in range(1, t_max):
        new_delta = np.full(n_states, neg_inf)
        new_entry = entry_time.copy()
        for s in range(n_states):
            cands = [(delta[s], entry_time[s])]
            if s >= 1:
                cands.append((delta[s - 1], t))
            if s >= 2 and s % 2 == 1 and state_token(s) != state_token(s - 2):
                cands.append((delta[s - 2], t))
            best, ent = max(cands, key=lambda c: c[0])
            new_delta[s] = best + log_probs[t, state_token(s)]
            if best == delta[s]:
                new_entry[s] = entry_time[s]
            else:
                new_entry[s] = t
        delta = new_delta
        entry_time = new_entry

    # approximate utterance boundaries by the most-likely terminal states'
    # entry times (greedy backwards pass over utter_bounds)
    segments = []
    for (s0, s1) in utter_bounds:
        # entry of the first token state and exit of the last token state
        start_t = int(entry_time[min(s0 + 1, n_states - 1)])
        end_t = int(entry_time[min(s1, n_states - 1)])
        if end_t <= start_t:
            end_t = min(start_t + 1, t_max)
        seg_lp = log_probs[start_t:end_t].max(axis=-1)
        conf = float(seg_lp.mean()) if len(seg_lp) else neg_inf
        segments.append((start_t * frame_duration, end_t * frame_duration, conf))
    return segments


class CTCSegmentationTask:
    """Result bundle of a segmentation run (reference
    ``ctc_segmentation.py:60``): per-utterance (start, end, confidence) plus
    the text, printable as a kaldi-style segments table."""

    def __init__(self, segments, text, name="utt"):
        self.segments = segments
        self.text = text
        self.name = name

    def __str__(self):
        lines = []
        for i, ((start, end, score), txt) in enumerate(zip(self.segments, self.text)):
            lines.append(f"{self.name}_{i:04} {self.name} {start:.2f} {end:.2f}"
                         f" {score:.9f} {txt}")
        return "\n".join(lines) + "\n"


class CTCSegmentation:
    """Align utterance texts inside long audio via CTC posteriors
    (reference ``ctc_segmentation.py:136``): wraps an ASR encoder + tokenizer
    and the dynamic-programming ``ctc_segmentation`` core."""

    def __init__(self, asr_model, kaldi_style_text=False, blank_id=0,
                 frame_duration=0.02, min_window=8000):
        self.asr_model = asr_model
        self.kaldi_style_text = kaldi_style_text
        self.blank_id = blank_id
        self.frame_duration = frame_duration
        self.min_window = min_window

    def get_lpz(self, wavs, wav_lens=None):
        """Encoder posteriors of the first row, (T, V) numpy in f64: the
        ``encode_batch`` output read to the host in one copy."""
        enc = self.asr_model.encode_batch(wavs, wav_lens)
        return enc[0].detach().to("cpu", torch.float64).numpy()

    def __call__(self, wavs, text, name="utt", wav_lens=None):
        if isinstance(text, str):
            text = text.splitlines()
        if self.kaldi_style_text:
            names = [t.split(" ", 1)[0] for t in text]
            text = [t.split(" ", 1)[1] if " " in t else "" for t in text]
            del names
        lpz = self.get_lpz(wavs, wav_lens)
        tok = self.asr_model.hparams.tokenizer
        token_ids = [
            tok.encode_as_ids(t) if hasattr(tok, "encode_as_ids")
            else tok.encode(t) for t in text]
        segments = ctc_segmentation(
            lpz, token_ids, blank_id=self.blank_id,
            frame_duration=self.frame_duration, min_window=self.min_window)
        return CTCSegmentationTask(segments, text, name=name)
