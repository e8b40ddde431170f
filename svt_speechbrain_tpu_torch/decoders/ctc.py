"""CTC decoding (port of ``svt_speechbrain_tpu/decoders/ctc.py``): greedy
decoding, the output filter, and the CTC prefix scorer of joint
CTC/attention beam search."""
from __future__ import annotations

import torch


def filter_ctc_output(string_pred, blank_id=-1):
    """Merge repeats, then drop blanks.

    Example
    -------
    >>> filter_ctc_output([0, 0, 3, 3, 0, 1, 1], blank_id=0)
    [3, 1]
    """
    if isinstance(string_pred, list):
        out = [v for i, v in enumerate(string_pred)
               if i == 0 or v != string_pred[i - 1]]
        return [v for v in out if v != blank_id]
    raise ValueError("filter_ctc_output expects a list")


def ctc_greedy_decode(probabilities, seq_lens, blank_id=-1):
    """Batch greedy CTC decode (``ctc.py:25``): argmax per frame (the first
    of equal maxima), each row cut to ``round(seq_len · T)`` frames of its
    relative length, repeats merged, blanks dropped. One read of the
    argmaxes from the device.

    Example
    -------
    >>> import torch
    >>> probs = torch.zeros(1, 4, 3)
    >>> probs[0, [0, 1, 2, 3], [1, 1, 0, 2]] = 1.0   # 1 1 blank(0) 2
    >>> ctc_greedy_decode(probs, [1.0], blank_id=0)
    [[1, 2]]
    """
    probabilities = torch.as_tensor(probabilities)
    if blank_id < 0:
        blank_id = probabilities.shape[-1] + blank_id
    batch_max_len = probabilities.shape[1]
    argmaxes = probabilities.argmax(-1).cpu()
    outputs = []
    for seq, seq_len in zip(argmaxes, torch.as_tensor(seq_lens).cpu()):
        actual_size = int(round(float(seq_len) * batch_max_len))
        outputs.append(filter_ctc_output(seq[:actual_size].tolist(),
                                         blank_id=blank_id))
    return outputs


def _logsumexp(a, dim):
    m = a.amax(dim=dim, keepdim=True)
    m = torch.where(torch.isfinite(m), m, 0.0)
    return m.squeeze(dim) + torch.log(torch.exp(a - m).sum(dim=dim))


class CTCPrefixScorer:
    """CTC prefix scorer for joint CTC/attention beam decoding
    (``ctc.py:57``; Watanabe et al., TR2017-190, Algorithm 2): the (r, psi,
    scoring_table) state, time pruning from the prefix length, partial
    scoring of candidates through the scoring table, the attention window,
    EOS scored from each utterance's last frame, blank excluded from the
    joint scores, and the vocab-flat ``permute_mem``. It runs in float64 on
    the device of ``x``; the attention window reads the attention peaks to
    the host once a step.

    ``x`` (B, T, V) are LOG posteriors from the CTC head, ``enc_lens`` the
    ABSOLUTE frame counts.

    Example
    -------
    >>> import torch
    >>> x = torch.log_softmax(torch.randn(1, 5, 4,
    ...     generator=torch.Generator().manual_seed(0)), -1)
    >>> scorer = CTCPrefixScorer(x, [5], 1, 2, blank_index=0, eos_index=3)
    >>> psi, state = scorer.forward_step(torch.zeros(2, 0, dtype=torch.long),
    ...                                  None)
    >>> tuple(psi.shape), float(psi[0, 0])        # blank never proposed
    ((2, 4), -1e+20)
    """

    def __init__(self, x, enc_lens, batch_size, beam_size, blank_index,
                 eos_index, ctc_window_size=0):
        self.blank_index = blank_index
        self.eos_index = eos_index
        self.batch_size = batch_size
        self.beam_size = beam_size
        self.ctc_window_size = ctc_window_size
        self.minus_inf = -1e20

        x = torch.as_tensor(x).to(torch.float64, copy=True)
        self.device = x.device
        self.max_enc_len = x.shape[1]
        self.vocab_size = x.shape[-1]
        enc_lens = torch.as_tensor(enc_lens, device=self.device).long()
        self.last_frame_index = enc_lens - 1

        # frames past each utterance's length: all minus-inf but a free
        # blank (the reference's column 0)
        mask = (torch.arange(self.max_enc_len, device=self.device)[None, :]
                >= enc_lens[:, None])
        x = x.masked_fill(mask[:, :, None], self.minus_inf)
        x[:, :, 0] = torch.where(mask, 0.0, x[:, :, 0])

        xnb = x.transpose(0, 1)                            # (T, B, V)
        xb = xnb[:, :, self.blank_index][:, :, None].expand_as(xnb)
        self.x = torch.stack([xnb, xb])                    # (2, T, B, V)
        self.beam_offset = torch.arange(batch_size,
                                        device=self.device) * beam_size
        self.cand_offset = torch.arange(batch_size,
                                        device=self.device) * self.vocab_size

    def _long(self, a):
        return torch.as_tensor(a, device=self.device).long()

    def forward_step(self, g, state, candidates=None, attn=None):
        """Score extending each prefix ``g`` (B·beam, prefix_len) by every
        vocab token (or only ``candidates`` (B·beam, C)); returns
        (psi - psi_prev, new state)."""
        g = self._long(g)
        n_bh = self.batch_size * self.beam_size
        prefix_length = g.shape[1] if g.dim() == 2 else 0
        rows = torch.arange(n_bh, device=self.device)
        last_char = (g[:, -1] if prefix_length > 0
                     else torch.zeros(n_bh, dtype=torch.long,
                                      device=self.device))
        self.num_candidates = (self.vocab_size if candidates is None
                               else candidates.shape[-1])
        if state is None:
            # empty-prefix forward variables: all-blank paths
            r_prev = torch.full((self.max_enc_len, 2, self.batch_size,
                                 self.beam_size), self.minus_inf,
                                dtype=torch.float64, device=self.device)
            r_prev[:, 1] = torch.cumsum(
                self.x[0, :, :, self.blank_index], 0)[:, :, None]
            r_prev = r_prev.reshape(-1, 2, n_bh)
            psi_prev = 0.0
        else:
            r_prev, psi_prev = state

        if candidates is not None:
            candidates = self._long(candidates)
            scoring_table = torch.full((n_bh, self.vocab_size), -1,
                                       dtype=torch.long, device=self.device)
            scoring_table[rows[:, None], candidates] = torch.arange(
                self.num_candidates, device=self.device)
            scoring_index = (
                candidates
                + self.cand_offset.repeat_interleave(self.beam_size)[:, None]
            ).reshape(-1)
            x_inflate = self.x.reshape(
                2, -1, self.batch_size * self.vocab_size)[
                :, :, scoring_index].reshape(2, -1, n_bh,
                                             self.num_candidates)
        else:
            scoring_table = None
            x_inflate = self.x.repeat_interleave(self.beam_size, dim=2)

        r = torch.full((self.max_enc_len, 2, n_bh, self.num_candidates),
                       self.minus_inf, dtype=torch.float64,
                       device=self.device)
        if prefix_length == 0:
            r[0, 0] = x_inflate[0, 0]
        r_sum = _logsumexp(r_prev, 1)                      # (T, n_bh)
        phi = r_sum[:, :, None].repeat(1, 1, self.num_candidates)
        # phi(last char of g) = r^b_prev
        if candidates is not None:
            pos = scoring_table[rows, last_char]
            sel = torch.nonzero(pos != -1).squeeze(1)
            phi[:, sel, pos[sel]] = r_prev[:, 1][:, sel]
        else:
            phi[:, rows, last_char] = r_prev[:, 1]

        # scoring frames: |g| < |h|, optional attention window
        if self.ctc_window_size == 0 or attn is None:
            start = max(1, prefix_length)
            end = self.max_enc_len
        else:
            attn_peak = torch.as_tensor(attn).argmax(dim=1).cpu()
            max_frame = int(attn_peak.max()) + self.ctc_window_size
            min_frame = int(attn_peak.min()) - self.ctc_window_size
            start = max(max(1, prefix_length), min_frame)
            end = min(self.max_enc_len, max_frame)

        for t in range(start, end):
            rnb_prev = r[t - 1, 0]
            rb_prev = r[t - 1, 1]
            r[t, 0] = torch.logaddexp(rnb_prev, phi[t - 1]) + x_inflate[0, t]
            r[t, 1] = torch.logaddexp(rnb_prev, rb_prev) + x_inflate[1, t]

        psi_init = r[start - 1, 0][None]
        phix = torch.cat((phi[0][None], phi[:-1]), dim=0) + x_inflate[0]
        psi_ = _logsumexp(torch.cat((phix[start:end], psi_init), dim=0), 0)
        if candidates is not None:
            psi = torch.full((n_bh, self.vocab_size), self.minus_inf,
                             dtype=torch.float64, device=self.device)
            psi[rows[:, None], candidates] = psi_
        else:
            psi = psi_

        # eos scores from each utterance's LAST VALID frame
        psi[:, self.eos_index] = r_sum[
            self.last_frame_index[rows // self.beam_size], rows]
        # blank never proposed by the joint decoder
        psi[:, self.blank_index] = self.minus_inf

        return psi - psi_prev, (r, psi, scoring_table)

    def permute_mem(self, memory, index):
        """Synchronize the scorer state with the search's top-k choice.
        ``index``: (B, beam) candidate indices in the beam·vocab-flattened
        space."""
        r, psi, scoring_table = memory
        index = self._long(index)
        best_index = (index + (self.beam_offset[:, None]
                               * self.vocab_size)).reshape(-1)
        psi = psi.reshape(-1)[best_index]
        psi = psi[:, None].expand(self.batch_size * self.beam_size,
                                  self.vocab_size).clone()
        if scoring_table is not None:
            effective_index = (index // self.vocab_size
                               + self.beam_offset[:, None]).reshape(-1)
            selected_vocab = (index % self.vocab_size).reshape(-1)
            score_index = scoring_table[effective_index, selected_vocab]
            score_index[score_index == -1] = 0
            best_index = score_index + effective_index * self.num_candidates
        r = r.reshape(-1, 2, self.batch_size * self.beam_size
                      * self.num_candidates)[:, :, best_index]
        return r, psi
