"""Seq2seq decoding (port of ``svt_speechbrain_tpu/decoders/seq2seq.py``).

A searcher wraps a step function ``forward_step(inp_tokens, memory,
enc_states, enc_lens) → (log_probs, memory, attn)`` that a subclass
supplies, and runs greedy or beam search. The network runs on the device of
``enc_states``; the beam bookkeeping is host code on numpy copies, one read
of a step's log-probabilities (and of its attention, when an option needs
it) a step. Ties rank by ascending flat index (stable sorts), as in the
JAX package. A searcher's ``host_reads`` counts those reads.

The searchers over models: ``S2SRNNGreedySearcher`` and
``S2SRNNBeamSearcher`` over an embedding, an ``AttentionalRNNDecoder`` and
a linear head; ``S2SRNNBeamSearchLM`` and ``S2SRNNBeamSearchTransformerLM``
with an LM's shallow fusion; ``S2STransformerBeamSearch`` over a
``TransformerASR``. The modules hold their parameters (the JAX searchers
take them beside the modules).
"""
from __future__ import annotations

import numpy as np
import torch

from svt_speechbrain_tpu_torch.decoders.ctc import CTCPrefixScorer


def _host(x):
    """A numpy copy of a tensor (one read from its device), or the array."""
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


class S2SBaseSearcher:
    """The searchers' common arguments (``seq2seq.py:17``). ``host_reads``
    counts the tensors the last search read to the host."""

    def __init__(self, bos_index, eos_index, min_decode_ratio,
                 max_decode_ratio):
        self.bos_index = bos_index
        self.eos_index = eos_index
        self.min_decode_ratio = min_decode_ratio
        self.max_decode_ratio = max_decode_ratio
        self.host_reads = 0

    def to(self, device):
        """Move the modules the searcher holds (its model, heads and LM)
        to ``device``, in eval mode; returns the searcher."""
        for value in vars(self).values():
            if isinstance(value, torch.nn.Module):
                value.to(device).eval()
        return self

    def _host(self, x):
        if torch.is_tensor(x):
            self.host_reads += 1
        return _host(x)

    def forward_step(self, inp_tokens, memory, enc_states, enc_lens):
        raise NotImplementedError

    def reset_mem(self, batch_size):
        return None


class S2SGreedySearcher(S2SBaseSearcher):
    """Greedy decoding (``seq2seq.py:33``): ``int(T · max_decode_ratio)``
    steps, each the argmax (the first of equal maxima); every hypothesis is
    cut at its first EOS and scored by the sum of its chosen log-probs over
    all steps. The tokens and log-probs are read once, at the end."""

    @torch.inference_mode()
    def __call__(self, enc_states, enc_lens):
        self.host_reads = 0
        batch_size = enc_states.shape[0]
        memory = self.reset_mem(batch_size)
        inp_tokens = torch.full((batch_size,), self.bos_index,
                                dtype=torch.long, device=enc_states.device)
        max_steps = int(enc_states.shape[1] * self.max_decode_ratio)
        log_probs_lst, tokens = [], []
        for _ in range(max_steps):
            log_probs, memory, _ = self.forward_step(
                inp_tokens, memory, enc_states, enc_lens)
            inp_tokens = log_probs.argmax(dim=-1)
            log_probs_lst.append(log_probs)
            tokens.append(inp_tokens)
        tokens = self._host(torch.stack(tokens, dim=1))
        all_log_probs = self._host(torch.stack(log_probs_lst, dim=1))
        hyps, scores = [], []
        for b in range(batch_size):
            seq = tokens[b].tolist()
            if self.eos_index in seq:
                seq = seq[:seq.index(self.eos_index)]
            hyps.append(seq)
            scores.append(float(all_log_probs[b, np.arange(len(tokens[b])),
                                              tokens[b]].sum()))
        return hyps, scores


class S2SBeamSearcher(S2SBaseSearcher):
    """Batched beam search (``seq2seq.py:85``) with an EOS threshold, length
    normalization and rewarding, joint CTC scoring (full or partial, with
    an attention window), a maximum attention shift, a coverage penalty,
    LM shallow fusion and ``return_topk``. Subclasses supply
    ``forward_step`` and ``permute_mem`` (and ``ctc_forward_step``,
    ``lm_forward_step``/``permute_lm_mem`` for the options that need
    them).

    Example
    -------
    >>> import torch
    >>> class Toy(S2SBeamSearcher):
    ...     def forward_step(self, inp_tokens, memory, enc_states, enc_lens):
    ...         logits = torch.tensor([0.0, 1.0, 2.0, 0.5]).repeat(
    ...             inp_tokens.shape[0], 1)
    ...         return torch.log_softmax(logits, -1), memory, None
    >>> search = Toy(bos_index=0, eos_index=1, min_decode_ratio=0.0,
    ...              max_decode_ratio=1.0, beam_size=2, eos_threshold=10.0)
    >>> hyps, scores = search(torch.zeros(1, 3, 4), torch.ones(1))
    >>> hyps, [round(s, 4) for s in scores]  # [2, eos] over [eos], per step
    ([[2]], [-1.046])
    """

    def __init__(self, bos_index, eos_index, min_decode_ratio,
                 max_decode_ratio, beam_size, scorer=None, return_topk=False,
                 topk=1, using_eos_threshold=True, eos_threshold=1.5,
                 length_normalization=True, length_rewarding=0,
                 ctc_weight=0.0, blank_index=0, ctc_score_mode="full",
                 ctc_window_size=0, using_max_attn_shift=False,
                 max_attn_shift=60, coverage_penalty=0.0, lm_weight=0.0,
                 minus_inf=-1e20):
        super().__init__(bos_index, eos_index, min_decode_ratio,
                         max_decode_ratio)
        self.beam_size = beam_size
        self.scorer = scorer
        self.return_topk = return_topk
        self.topk = topk
        self.using_eos_threshold = using_eos_threshold
        self.eos_threshold = eos_threshold
        self.length_normalization = length_normalization
        self.length_rewarding = length_rewarding
        self.minus_inf = minus_inf
        self.ctc_weight = ctc_weight
        self.blank_index = blank_index
        self.att_weight = 1.0 - ctc_weight
        assert 0.0 <= self.ctc_weight <= 1.0, \
            "ctc_weight should not > 1.0 and < 0.0"
        if self.ctc_weight > 0.0 and len(
                {self.bos_index, self.eos_index, self.blank_index}) < 3:
            raise ValueError(
                "To perform joint ATT/CTC decoding, set blank, eos and bos "
                "to different indexes.")
        self.ctc_score_mode = ctc_score_mode
        self.ctc_window_size = ctc_window_size
        self.using_max_attn_shift = using_max_attn_shift
        self.max_attn_shift = max_attn_shift
        self.coverage_penalty = coverage_penalty
        # LM shallow fusion happens after the eos threshold and before CTC,
        # unscaled by att_weight
        self.lm_weight = lm_weight

    def lm_forward_step(self, inp_tokens, memory):
        """LM log-probs for the next token; subclasses with
        ``lm_weight > 0`` provide this."""
        raise NotImplementedError

    def reset_lm_mem(self, batch_size):
        return None

    def permute_lm_mem(self, memory, index):
        return memory

    def ctc_forward_step(self, x):
        """CTC head log-posteriors over encoder states; subclasses that
        decode jointly provide this."""
        raise NotImplementedError(
            "Joint CTC decoding requires the subclass to implement "
            "ctc_forward_step (a CTC output head over encoder states).")

    def permute_mem(self, memory, index):
        """Reorder recurrent state after top-k; default none."""
        return memory

    @torch.inference_mode()
    def __call__(self, enc_states, enc_lens):
        self.host_reads = 0
        batch_size = enc_states.shape[0]
        beam = self.beam_size
        device = enc_states.device
        enc_lens = torch.as_tensor(enc_lens, device=device)
        ctc_scorer, ctc_memory = None, None
        if self.ctc_weight > 0.0:
            enc_lens_abs = np.round(
                enc_states.shape[1] * self._host(enc_lens)).astype(np.int64)
            ctc_scorer = CTCPrefixScorer(
                self.ctc_forward_step(enc_states), enc_lens_abs, batch_size,
                beam, self.blank_index, self.eos_index, self.ctc_window_size)
        enc_states_b = enc_states.repeat_interleave(beam, dim=0)
        enc_lens_b = enc_lens.repeat_interleave(beam, dim=0)
        memory = self.reset_mem(batch_size * beam)
        lm_memory = (self.reset_lm_mem(batch_size * beam)
                     if self.lm_weight > 0 else None)

        inp_tokens = torch.full((batch_size * beam,), self.bos_index,
                                dtype=torch.long, device=device)
        # only the first beam of each batch is alive initially
        scores = np.full((batch_size, beam), self.minus_inf, np.float32)
        scores[:, 0] = 0.0
        scores = scores.reshape(-1)

        hyps = [[] for _ in range(batch_size * beam)]
        finished = [[] for _ in range(batch_size)]  # (tokens, score)
        max_steps = int(enc_states.shape[1] * self.max_decode_ratio)
        min_steps = int(enc_states.shape[1] * self.min_decode_ratio)
        prev_attn_peak = np.zeros(batch_size * beam)
        coverage = None
        finalize_scores = np.full(batch_size * beam, -np.inf)
        needs_attn = self.using_max_attn_shift or self.coverage_penalty > 0

        for step in range(max_steps):
            log_probs, memory, attn = self.forward_step(
                inp_tokens, memory, enc_states_b, enc_lens_b)
            vocab = log_probs.shape[-1]
            log_probs = self.att_weight * self._host(log_probs)
            attn_np = self._host(attn) if needs_attn else None
            if self.using_max_attn_shift:
                # block candidates whose attention peak jumped too far
                attn_peak = attn_np.argmax(axis=1)
                cond = ((attn_peak <= prev_attn_peak + self.max_attn_shift)
                        & (attn_peak > prev_attn_peak - self.max_attn_shift))
                log_probs = np.where(cond[:, None], log_probs,
                                     self.minus_inf)
            if step < min_steps:
                log_probs[:, self.eos_index] = self.minus_inf
            if self.using_eos_threshold:
                max_probs = log_probs.max(axis=-1)
                thresh = self.eos_threshold * max_probs
                # keep eos only when strictly above the threshold
                bad_eos = log_probs[:, self.eos_index] <= thresh
                log_probs[bad_eos, self.eos_index] = self.minus_inf

            if self.lm_weight > 0:
                lm_log_probs, lm_memory = self.lm_forward_step(inp_tokens,
                                                               lm_memory)
                log_probs = log_probs + self.lm_weight * self._host(
                    lm_log_probs)

            if ctc_scorer is not None:
                # joint scoring: block blank, optionally prune the scorer's
                # vocab to 2*beam candidates
                g = np.asarray(hyps, np.int64)
                if g.ndim != 2:   # step 0: prefixes are empty
                    g = np.zeros((batch_size * beam, 0), np.int64)
                log_probs[:, self.blank_index] = self.minus_inf
                if (self.ctc_weight != 1.0
                        and self.ctc_score_mode == "partial"):
                    ctc_candidates = np.argsort(
                        -log_probs, axis=-1)[:, : 2 * beam]
                else:
                    ctc_candidates = None
                ctc_log_probs, ctc_memory = ctc_scorer.forward_step(
                    g, ctc_memory, ctc_candidates, attn)
                # float32: in saturated (-1e20-dominated) regimes the tie
                # structure is precision-dependent
                log_probs = (log_probs + self.ctc_weight
                             * self._host(ctc_log_probs)).astype(np.float32)

            cand = scores[:, None] + log_probs                # (B*beam, V)
            cand = cand.reshape(batch_size, beam * vocab)
            top_scores_idx = np.argsort(-cand, axis=1,
                                        kind="stable")[:, :beam]
            top_scores = np.take_along_axis(cand, top_scores_idx, axis=1)
            beam_idx = top_scores_idx // vocab  # within-batch beam index
            tok_idx = top_scores_idx % vocab

            flat_beam_idx = (beam_idx + np.arange(batch_size)[:, None]
                             * beam).reshape(-1)
            hyps = [hyps[i] + [int(t)] for i, t in
                    zip(flat_beam_idx, tok_idx.reshape(-1))]
            scores = np.asarray(top_scores.reshape(-1), np.float32)
            inp_tokens = torch.as_tensor(tok_idx.reshape(-1),
                                         device=device).long()
            memory = self.permute_mem(
                memory, torch.as_tensor(flat_beam_idx, device=device))
            if self.lm_weight > 0:
                lm_memory = self.permute_lm_mem(lm_memory, flat_beam_idx)
            if ctc_scorer is not None:
                ctc_memory = ctc_scorer.permute_mem(ctc_memory,
                                                    top_scores_idx)
            if self.using_max_attn_shift:
                prev_attn_peak = attn_peak[flat_beam_idx]

            # the score a finalized hypothesis is stored with: normalized,
            # minus the coverage penalty, which never feeds back into the
            # running scores
            finalize_scores = scores.astype(np.float64)
            if self.length_normalization:
                finalize_scores = finalize_scores / (step + 1)
            if self.coverage_penalty > 0:
                cur_attn = attn_np[flat_beam_idx]
                if cur_attn.ndim > 2:
                    # transformer attention (B*beam, steps, src): coverage
                    # is the sum over decoded steps
                    coverage = cur_attn.sum(axis=1)
                else:
                    # the reference's step-0 branch falls through into the
                    # update, permuting and counting the first step twice
                    base = cur_attn if step == 0 else coverage
                    coverage = base[flat_beam_idx] + cur_attn
                penalty = (np.maximum(coverage, 0.5).sum(axis=-1)
                           - coverage.shape[-1] * 0.5)
                if self.length_normalization:
                    penalty = penalty / (step + 1)
                finalize_scores = finalize_scores \
                    - penalty * self.coverage_penalty

            # collect finished hypotheses: per batch at most beam_size,
            # first come kept
            ended = tok_idx.reshape(-1) == self.eos_index
            for i in np.flatnonzero(ended):
                b = i // beam
                if len(finished[b]) == beam:
                    continue
                score = float(finalize_scores[i]) \
                    + self.length_rewarding * (step + 1)
                finished[b].append((hyps[i][:-1], score))
            # a finished row's candidates all tie at -inf and never
            # re-enter the ranking
            scores[ended] = -np.inf
            if all(len(f) == beam for f in finished):
                break
        # force-finalize the rows still alive, with the last step's
        # (penalized, normalized) scores
        if not all(len(f) == beam for f in finished):
            for i in range(batch_size * beam):
                b = i // beam
                if len(finished[b]) == beam:
                    continue
                sc = float(finalize_scores[i]) \
                    + self.length_rewarding * (max_steps + 1)
                finished[b].append((hyps[i], sc))
        out_hyps, out_scores = [], []
        for b in range(batch_size):
            ranked = sorted(finished[b], key=lambda t: -t[1])
            # trim at the first eos (force-finalized rows may carry an
            # earlier eos mid-sequence)
            ranked = [(filter_seq2seq_output(list(map(int, h)),
                                             eos_id=self.eos_index), s)
                      for h, s in ranked]
            if self.return_topk:
                out_hyps.append([h for h, s in ranked[:self.topk]])
                out_scores.append([s for h, s in ranked[:self.topk]])
            else:
                out_hyps.append(ranked[0][0])
                out_scores.append(ranked[0][1])
        return out_hyps, out_scores


def filter_seq2seq_output(string_pred, eos_id=-1):
    """Trim everything from the first eos.

    Example
    -------
    >>> filter_seq2seq_output([3, 5, 2, 7], eos_id=2)
    [3, 5]
    >>> filter_seq2seq_output([3, 5], eos_id=2)     # no eos: unchanged
    [3, 5]
    """
    if not isinstance(string_pred, list):
        raise ValueError("The input must be a list.")
    try:
        first = next(i for i, v in enumerate(string_pred) if v == eos_id)
        return string_pred[:first]
    except StopIteration:
        return string_pred


def batch_filter_seq2seq_output(prediction, eos_id=-1):
    """``filter_seq2seq_output`` of each batch item."""
    return [filter_seq2seq_output(list(map(int, p)), eos_id=eos_id)
            for p in prediction]


def inflate_tensor(tensor, times, dim):
    """Repeat each entry ``times`` times along ``dim``."""
    return torch.repeat_interleave(tensor, times, dim=dim)


def mask_by_condition(tensor, cond, fill_value):
    """``tensor`` where ``cond``, else ``fill_value``."""
    return torch.where(cond, tensor, fill_value)


def _device_of(module):
    return next(module.parameters()).device


class _RNNStep:
    """The step of the searchers over embedding → ``AttentionalRNNDecoder``
    → linear (``seq2seq.py:74``): the relative ``enc_lens`` become frames
    as round(T · enc_lens), half to even."""

    def _step(self, inp_tokens, memory, enc_states, enc_lens, temperature):
        e = self.emb(inp_tokens)
        c = memory["c"]
        if c is None:
            c = enc_states.new_zeros(inp_tokens.shape[0], self.dec.attn_dim)
        enc_lens = torch.as_tensor(enc_lens, device=enc_states.device)
        enc_len = torch.round(enc_states.shape[1] * enc_lens.float())
        dec_out, hs, c, w, attn_state = self.dec.forward_step(
            e, memory["hs"], c, enc_states, enc_len, memory["attn_state"])
        log_probs = torch.log_softmax(self.fc(dec_out) / temperature, dim=-1)
        return log_probs, dict(memory, hs=hs, c=c, attn_state=attn_state), w


class S2SRNNGreedySearcher(_RNNStep, S2SGreedySearcher):
    """Greedy search over ``embedding`` → ``decoder`` (an
    ``AttentionalRNNDecoder``) → ``linear`` (``seq2seq.py:62``).

    Example
    -------
    >>> import torch
    >>> from svt_speechbrain_tpu_torch.nnet.embedding import Embedding
    >>> from svt_speechbrain_tpu_torch.nnet.linear import Linear
    >>> from svt_speechbrain_tpu_torch.nnet.rnn import AttentionalRNNDecoder
    >>> dec = AttentionalRNNDecoder("gru", "content", hidden_size=6,
    ...                             attn_dim=5, num_layers=1, enc_dim=4,
    ...                             input_size=3)
    >>> search = S2SRNNGreedySearcher(Embedding(7, 3), dec, Linear(7, 6),
    ...                               bos_index=0, eos_index=1,
    ...                               min_decode_ratio=0.0,
    ...                               max_decode_ratio=1.0)
    >>> hyps, scores = search(torch.ones(2, 4, 4), torch.ones(2))
    >>> len(hyps), len(scores)
    (2, 2)
    """

    def __init__(self, embedding, decoder, linear, **kwargs):
        super().__init__(**kwargs)
        self.emb = embedding
        self.dec = decoder
        self.fc = linear

    def reset_mem(self, batch_size):
        return {"hs": None, "attn_state": None,
                "c": torch.zeros(batch_size, self.dec.attn_dim,
                                 device=_device_of(self.dec))}

    def forward_step(self, inp_tokens, memory, enc_states, enc_lens):
        return self._step(inp_tokens, memory, enc_states, enc_lens, 1.0)


class S2SRNNBeamSearcher(_RNNStep, S2SBeamSearcher):
    """Beam search over ``embedding`` → ``decoder`` → ``linear``
    (``seq2seq.py:342``), with ``temperature`` on the logits and, for joint
    CTC decoding, the CTC head ``ctc_linear`` over the encoder states.
    ``permute_mem`` reorders the cell states (an LSTM's (h, c) pairs), the
    context and the location-aware attention's previous weights.

    Example
    -------
    >>> import torch
    >>> from svt_speechbrain_tpu_torch.nnet.embedding import Embedding
    >>> from svt_speechbrain_tpu_torch.nnet.linear import Linear
    >>> from svt_speechbrain_tpu_torch.nnet.rnn import AttentionalRNNDecoder
    >>> dec = AttentionalRNNDecoder("gru", "location", hidden_size=6,
    ...                             attn_dim=5, num_layers=1, enc_dim=4,
    ...                             input_size=3, channels=2, kernel_size=2)
    >>> search = S2SRNNBeamSearcher(Embedding(7, 3), dec, Linear(7, 6),
    ...                             bos_index=0, eos_index=1,
    ...                             min_decode_ratio=0.0,
    ...                             max_decode_ratio=1.0, beam_size=2)
    >>> hyps, scores = search(torch.ones(2, 4, 4), torch.ones(2))
    >>> len(hyps), len(scores)
    (2, 2)
    """

    def __init__(self, embedding, decoder, linear, temperature=1.0,
                 ctc_linear=None, **kwargs):
        super().__init__(**kwargs)
        self.emb = embedding
        self.dec = decoder
        self.fc = linear
        self.temperature = temperature
        self.ctc_fc = ctc_linear
        if self.ctc_weight > 0.0 and self.ctc_fc is None:
            raise ValueError(
                "To perform joint ATT/CTC decoding, ctc_fc is required.")

    def ctc_forward_step(self, x):
        return torch.log_softmax(self.ctc_fc(x), dim=-1)

    def reset_mem(self, batch_size):
        return {"hs": None, "c": None, "attn_state": None,
                "batch_size": batch_size}

    def forward_step(self, inp_tokens, memory, enc_states, enc_lens):
        return self._step(inp_tokens, memory, enc_states, enc_lens,
                          self.temperature)

    def permute_mem(self, memory, index):
        hs = memory["hs"]
        if hs is not None:
            hs = [tuple(x[index] for x in s) if isinstance(s, tuple)
                  else s[index] for s in hs]
        c = memory["c"][index] if memory["c"] is not None else None
        attn_state = (memory["attn_state"][index]
                      if memory["attn_state"] is not None else None)
        return dict(memory, hs=hs, c=c, attn_state=attn_state)


class S2SRNNBeamSearchLM(S2SRNNBeamSearcher):
    """RNN beam search with an LM's shallow fusion (``seq2seq.py:435``):
    a token's score becomes log p_asr + ``lm_weight`` · log p_lm. The LM
    memory is the token prefix, on the device, rescored whole each step
    (``language_model(prefix)``, its last position's logits over
    ``temperature_lm``), as in the JAX searcher.

    Example
    -------
    >>> import torch
    >>> from svt_speechbrain_tpu_torch.models.rnnlm import RNNLM
    >>> from svt_speechbrain_tpu_torch.nnet.embedding import Embedding
    >>> from svt_speechbrain_tpu_torch.nnet.linear import Linear
    >>> from svt_speechbrain_tpu_torch.nnet.rnn import AttentionalRNNDecoder
    >>> dec = AttentionalRNNDecoder("gru", "content", hidden_size=6,
    ...                             attn_dim=5, num_layers=1, enc_dim=4,
    ...                             input_size=3)
    >>> lm = RNNLM(7, embedding_dim=3, rnn_layers=1, rnn_neurons=4,
    ...            dnn_neurons=5)
    >>> search = S2SRNNBeamSearchLM(Embedding(7, 3), dec, Linear(7, 6), lm,
    ...                             lm_weight=0.5, bos_index=0, eos_index=1,
    ...                             min_decode_ratio=0.0,
    ...                             max_decode_ratio=1.0, beam_size=2)
    >>> len(search(torch.ones(1, 3, 4), torch.ones(1))[0])
    1
    """

    def __init__(self, embedding, decoder, linear, language_model,
                 lm_weight=0.0, temperature_lm=1.0, **kwargs):
        super().__init__(embedding, decoder, linear, lm_weight=lm_weight,
                         **kwargs)
        self.lm = language_model
        self.temperature_lm = temperature_lm

    def reset_lm_mem(self, batch_size):
        return torch.full((batch_size, 0), self.bos_index, dtype=torch.long,
                          device=_device_of(self.lm))

    def lm_forward_step(self, inp_tokens, memory):
        prefix = torch.cat([memory, inp_tokens.to(memory.device)[:, None]],
                           dim=1)
        out = self.lm(prefix)
        logits = out[0] if isinstance(out, tuple) else out
        return torch.log_softmax(logits[:, -1] / self.temperature_lm,
                                 dim=-1), prefix

    def permute_lm_mem(self, memory, index):
        return memory[torch.as_tensor(index, device=memory.device)]


class S2SRNNBeamSearchTransformerLM(S2SRNNBeamSearchLM):
    """RNN beam search with a ``TransformerLM``'s shallow fusion
    (``seq2seq.py:465``): the same prefix rescoring."""


class S2STransformerBeamSearch(S2SBeamSearcher):
    """Beam search over a ``TransformerASR`` (``seq2seq.py:471``):
    ``modules`` = [model, seq_lin] (and ctc_lin for joint decoding). Each
    step decodes the whole token prefix and reads the last position's
    logits over ``temperature``. As in the JAX searcher the decoder gets no
    encoder padding mask: a shorter row's padded frames are attended.

    Example
    -------
    >>> import torch
    >>> from svt_speechbrain_tpu_torch.models.transformer_asr import (
    ...     TransformerASR)
    >>> from svt_speechbrain_tpu_torch.nnet.linear import Linear
    >>> asr = TransformerASR(7, 4, d_model=8, nhead=2, num_encoder_layers=1,
    ...                      num_decoder_layers=1, d_ffn=16)
    >>> search = S2STransformerBeamSearch([asr, Linear(7, 8)], bos_index=0,
    ...                                   eos_index=1, min_decode_ratio=0.0,
    ...                                   max_decode_ratio=1.0, beam_size=2)
    >>> enc, _ = asr.encode(torch.ones(2, 3, 4))
    >>> len(search(enc, torch.ones(2))[0])
    2
    """

    def __init__(self, modules, temperature=1.0, **kwargs):
        super().__init__(**kwargs)
        self.model = modules[0]
        self.seq_lin = modules[1]
        self.ctc_fc = modules[2] if len(modules) > 2 else None
        self.temperature = temperature
        if self.ctc_weight > 0.0 and self.ctc_fc is None:
            raise ValueError(
                "To perform joint ATT/CTC decoding, pass ctc_lin as "
                "modules[2].")

    def ctc_forward_step(self, x):
        return torch.log_softmax(self.ctc_fc(x), dim=-1)

    def reset_mem(self, batch_size):
        return {"prefix": torch.zeros(batch_size, 0, dtype=torch.long,
                                      device=_device_of(self.model))}

    def forward_step(self, inp_tokens, memory, enc_states, enc_lens):
        prefix = torch.cat([memory["prefix"], inp_tokens[:, None]], dim=1)
        dec_out = self.model.decode(prefix, enc_states)
        logits = self.seq_lin(dec_out[:, -1])
        log_probs = torch.log_softmax(logits / self.temperature, dim=-1)
        return log_probs, {"prefix": prefix}, None

    def permute_mem(self, memory, index):
        return {"prefix": memory["prefix"][index]}
