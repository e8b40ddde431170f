"""fairseq-semantics beam search for seq2seq decoders (port of
``svt_speechbrain_tpu/decoders/fairseq_generator.py``).

The beam semantics of fairseq's ``SequenceGenerator``:

- each step ranks ``2 * beam`` candidates over (cumulative score + lprob),
  only beam 0 competing at step 0, and never selects pad;
- EOS candidates are finalized only from the top ``beam`` ranks, their
  scores normalized by ``(step + 1) ** len_penalty``;
- the non-EOS survivors are the ``beam`` smallest entries of the
  eos/ignore-penalized candidate ranking (fairseq's ``active_mask`` trick);
- a sentence finishes when ``beam`` hypotheses are finalized or the loop
  reaches ``max_len``; hypotheses come back sorted by normalized score.

Three routes, one result:

- ``generate()`` on the host path: each step's log-probabilities come to
  the host and the bookkeeping runs in numpy (LM shallow fusion, prefix
  forcing, ensembles);
- ``generate()`` on its fast path (one decoder, no LM, no prefix,
  ``vocab - 2 >= 2 * beam``): the candidates are chosen on the device and
  one packed (3, B, 2·beam) int32 tensor comes to the host a step;
- ``generate_on_device()``: the whole search (ranking, finalization, the
  survivors, the cache reorder) stays on the device; a step reads one
  scalar (are all sentences finished?) and the finalized buffers come to
  the host once, at the end.

Ranks follow ``jax.lax.top_k`` and ``np.argsort(kind="stable")``: equal
scores keep the lower flat index first (``torch.sort(stable=True)``, never
``torch.topk``, whose tie order is not defined). ``stats`` holds the last
call's steps and device-to-host reads.
"""
from __future__ import annotations

import numpy as np
import torch

from svt_speechbrain_tpu_torch.decoders.seq2seq import _host


def _ranked(flat, k):
    """The ``k`` largest of each row of ``flat`` and their indices, equal
    values in ascending index order."""
    values, index = torch.sort(flat, dim=1, descending=True, stable=True)
    return values[:, :k], index[:, :k]


class FairseqSequenceGenerator:
    """Beam-decode a ``FairseqTransformerDecoder`` over encoder features.

    ``decoder`` is one decoder or a list of decoders of one architecture (an
    ensemble, scored as fairseq's ``EnsembleModel``: the logsumexp mean of
    the members' log-probabilities). ``lm`` is a shallow-fusion LM: a
    callable from the tokens so far, (N, t+1) int64 on the decoder's
    device, to the last position's log-probabilities (N, V), a tensor or an
    array; they are added times ``lm_weight``.

    Example
    -------
    >>> import torch
    >>> from svt_speechbrain_tpu_torch.convert_jax import (
    ...     init_fairseq_decoder, load_module_tree)
    >>> from svt_speechbrain_tpu_torch.models.seq2seq_decoder import (
    ...     FairseqDecoderConfig, FairseqTransformerDecoder)
    >>> cfg = FairseqDecoderConfig(vocab_size=9, embed_dim=8, ffn_dim=16,
    ...                            num_layers=1, num_heads=2)
    >>> dec = FairseqTransformerDecoder(cfg)
    >>> load_module_tree(dec, init_fairseq_decoder(
    ...     cfg, torch.Generator().manual_seed(0)))
    >>> gen = FairseqSequenceGenerator(dec, beam_size=2, max_len_b=5)
    >>> enc = torch.randn(2, 4, 8, generator=torch.Generator().manual_seed(1))
    >>> out = gen.generate(enc)
    >>> len(out), sorted(out[0][0])
    (2, ['positional_scores', 'score', 'tokens'])
    >>> int(out[0][0]["tokens"][-1])   # every hypothesis ends in EOS
    2
    """

    def __init__(self, decoder, beam_size=5, max_len_a=0.0, max_len_b=200,
                 min_len=1, normalize_scores=True, len_penalty=1.0,
                 unk_penalty=0.0, temperature=1.0, pad=None, unk=None,
                 eos=None, lm=None, lm_weight=1.0):
        self.members = (list(decoder) if isinstance(decoder, (list, tuple))
                        else [decoder])
        self.decoder = self.members[0]
        self.lm = lm
        self.lm_weight = lm_weight
        vocab = self.decoder.cfg.vocab_size
        self.vocab_size = vocab
        self.beam_size = min(beam_size, vocab - 1)
        self.max_len_a = max_len_a
        self.max_len_b = max_len_b
        self.min_len = min_len
        self.normalize_scores = normalize_scores
        self.len_penalty = len_penalty
        self.unk_penalty = unk_penalty
        self.temperature = temperature
        # fairseq Dictionary defaults: <s>=0 is bos, <pad>=1, </s>=2, <unk>=3
        self.pad = self.decoder.cfg.padding_idx if pad is None else pad
        self.eos = 2 if eos is None else eos
        self.unk = 3 if unk is None else unk
        self.stats = {"steps": 0, "host_reads": 0}

    # ------------------------------------------------------------ helpers

    def _max_len(self, encoder_out):
        src_len = int(encoder_out.shape[1])
        return min(int(self.max_len_a * src_len + self.max_len_b),
                   self.decoder.cfg.max_target_positions - 1)

    def _read(self, x):
        """``x`` as a numpy array; a tensor's read is counted."""
        self.stats["host_reads"] += torch.is_tensor(x)
        return _host(x)

    def _log_probs(self, decoder, cache, tokens_t, step):
        logits = decoder.step(cache, tokens_t, step)
        return torch.log_softmax(logits.float() / self.temperature, dim=-1)

    def _masked(self, lp, step, max_len):
        """The device routes' masks: NaN → -inf, pad never, the unk
        penalty, EOS forced at ``max_len`` and barred before ``min_len``."""
        lp = torch.where(torch.isnan(lp), -torch.inf, lp)
        lp[:, self.pad] = -torch.inf
        lp[:, self.unk] -= self.unk_penalty
        if step >= max_len:
            keep = lp[:, self.eos].clone()
            lp[:] = -torch.inf
            lp[:, self.eos] = keep
        if step < self.min_len:
            lp[:, self.eos] = -torch.inf
        return lp

    def _device_candidates(self, cache, tokens_t, step, cum, max_len, bsz):
        """The fast path's step (``fairseq_generator.py:101``): candidate
        scores, tokens and beams, (bsz, 2·beam) each, packed into one int32
        tensor (the scores' bits reinterpreted)."""
        beam = self.beam_size
        lp = self._masked(self._log_probs(self.decoder, cache, tokens_t, step),
                          step, max_len)
        v = lp.shape[-1]
        flat = (lp + cum[:, None]).reshape(bsz, beam * v)
        if step == 0:                     # every beam is identical
            flat[:, v:] = -torch.inf
        cs, idx = _ranked(flat, 2 * beam)
        return torch.stack([cs.contiguous().view(torch.int32),
                            (idx % v).int(), (idx // v).int()])

    def _candidates(self, step, lprobs, scores):
        """fairseq ``search.BeamSearch.step`` on the host: the top
        ``2*beam`` of the flattened (beam, vocab) cumulative scores."""
        bsz, beams, vocab = lprobs.shape
        if step == 0:
            flat = lprobs[:, 0]                      # only the first beam
        else:
            flat = (lprobs + scores[:, :, None]).reshape(bsz, -1)
        k = min(2 * self.beam_size, flat.shape[1] - 1)
        order = np.argsort(-flat, axis=1, kind="stable")[:, :k]
        cand_scores = np.take_along_axis(flat, order, axis=1)
        cand_beams = order // vocab if step > 0 else np.zeros_like(order)
        cand_tokens = order % vocab if step > 0 else order
        return cand_scores, cand_tokens, cand_beams

    def _prefix_tokens(self, step, lprobs, scores, tokens, prefix_tokens,
                       beam, bsz):
        """Force ``prefix_tokens[:, step]``: rows with a non-pad prefix
        token keep only that token's lprob; an EOS in the prefix replicates
        beam 0 across the sentence's beams."""
        ptoks = np.repeat(prefix_tokens[:, step], beam)          # (B*beam,)
        plp = lprobs[np.arange(len(ptoks)), ptoks].copy()
        forced = np.where(ptoks != self.pad)[0]
        lprobs[forced, :] = -np.inf
        lprobs[forced, ptoks[forced]] = plp[forced]
        eos_rows = ptoks == self.eos
        if eos_rows.any():
            sent_mask = eos_rows.reshape(bsz, beam)[:, 0]

            def replicate_first_beam(arr):
                v = arr.reshape(bsz, beam, -1)
                v[sent_mask] = v[sent_mask][:, :1, :]
                return v.reshape(bsz * beam, -1)

            tokens = replicate_first_beam(tokens)
            scores = replicate_first_beam(scores)
            lprobs = replicate_first_beam(lprobs)
        return lprobs, tokens, scores

    def _host_candidates(self, caches, tokens, scores, prefix_tokens, step,
                         max_len, bsz, beam, device):
        """The full-lprobs host path (LM fusion, prefix forcing, ensembles,
        small vocabularies). Mutates ``tokens``/``scores`` in place when an
        EOS in the prefix replicates beam 0."""
        tokens_t = torch.as_tensor(tokens[:, step], device=device).long()
        member_lps = [self._read(self._log_probs(m, c, tokens_t, step))
                      for m, c in zip(self.members, caches)]
        if len(member_lps) == 1:
            lprobs = np.array(member_lps[0], np.float32)
        else:  # fairseq EnsembleModel: logsumexp average of log-probs
            stacked = np.stack(member_lps)
            mx = stacked.max(axis=0)
            lprobs = (mx + np.log(np.exp(stacked - mx).sum(axis=0))
                      - np.log(len(member_lps))).astype(np.float32)
        if self.lm is not None:
            prefix = torch.as_tensor(tokens[:, : step + 1],
                                     device=device).long()
            lprobs = lprobs + self.lm_weight * np.asarray(
                self._read(self.lm(prefix)), np.float32)
        lprobs[np.isnan(lprobs)] = -np.inf
        lprobs[:, self.pad] = -np.inf
        lprobs[:, self.unk] -= self.unk_penalty
        if step >= max_len:                      # force EOS
            lprobs[:, : self.eos] = -np.inf
            lprobs[:, self.eos + 1:] = -np.inf

        if (prefix_tokens is not None and step < prefix_tokens.shape[1]
                and step < max_len):
            lprobs, new_tokens, new_scores = self._prefix_tokens(
                step, lprobs, scores, tokens, prefix_tokens, beam, bsz)
            tokens[:] = new_tokens
            scores[:] = new_scores
        elif step < self.min_len:
            # min-length does not apply while forcing a prefix
            lprobs[:, self.eos] = -np.inf

        return self._candidates(
            step, lprobs.reshape(bsz, beam, -1),
            scores[:, step - 1].reshape(bsz, beam) if step > 0 else None)


    # ------------------------------------------------------ the host loop

    @torch.inference_mode()
    def generate(self, encoder_out, encoder_padding_mask=None, bos_token=None,
                 prefix_tokens=None):
        """Decode a batch: ``encoder_out`` (B, S, D) on the decoder's
        device, ``encoder_padding_mask`` (B, S) True = padding. Returns per
        sentence up to ``beam_size`` hypothesis dicts (``tokens`` with the
        final EOS, ``score``, ``positional_scores``; CPU tensors) sorted by
        descending score. ``prefix_tokens`` (B, P) forces the first P
        tokens of each sentence (pad = no constraint at that position)."""
        bsz = int(encoder_out.shape[0])
        beam = self.beam_size
        device = encoder_out.device
        max_len = self._max_len(encoder_out)
        bos = self.eos if bos_token is None else bos_token
        self.stats = {"steps": 0, "host_reads": 0}
        if prefix_tokens is not None:
            prefix_tokens = _host(prefix_tokens)

        caches = [m.init_cache(encoder_out, max_len + 2,
                               encoder_padding_mask=encoder_padding_mask,
                               beam=beam)
                  for m in self.members]
        tokens = np.full((bsz * beam, max_len + 2), self.pad, np.int32)
        tokens[:, 0] = bos
        scores = np.zeros((bsz * beam, max_len + 1), np.float32)
        cands_to_ignore = np.zeros((bsz, beam), bool)
        finalized = [[] for _ in range(bsz)]
        finished = [False] * bsz

        # the vocab guard keeps every one of the 2*beam device candidates
        # finite with pad (and perhaps eos) at -inf
        fast = (self.lm is None and prefix_tokens is None
                and len(self.members) == 1
                and self.vocab_size - 2 >= 2 * beam)
        for step in range(max_len + 1):
            self.stats["steps"] += 1
            if fast:
                cum = (scores[:, step - 1] if step > 0
                       else np.zeros(bsz * beam, np.float32))
                packed = self._read(self._device_candidates(
                    caches[0],
                    torch.as_tensor(tokens[:, step], device=device).long(),
                    step, torch.as_tensor(cum, device=device), max_len, bsz))
                cand_scores = packed[0].view(np.float32)
                cand_tokens = packed[1]
                cand_beams = packed[2]
            else:
                cand_scores, cand_tokens, cand_beams = self._host_candidates(
                    caches, tokens, scores, prefix_tokens, step, max_len,
                    bsz, beam, device)
            cand_rows = cand_beams + np.arange(bsz)[:, None] * beam

            # finalize EOS candidates that rank in the top `beam`
            eos_mask = (cand_tokens == self.eos) & (cand_scores != -np.inf)
            eos_mask[:, :beam][cands_to_ignore] = False
            for sent in range(bsz):
                if finished[sent]:
                    continue
                for j in range(beam):
                    if not eos_mask[sent, j]:
                        continue
                    row = cand_rows[sent, j]
                    eos_score = cand_scores[sent, j]
                    hyp = tokens[row, 1: step + 2].copy()
                    hyp[step] = self.eos
                    pos = scores[row, : step + 1].copy()
                    pos[step] = eos_score
                    pos[1:] -= pos[:-1].copy()
                    final = eos_score
                    if self.normalize_scores:
                        final = eos_score / (step + 1) ** self.len_penalty
                    if len(finalized[sent]) < beam:
                        finalized[sent].append({
                            "tokens": torch.from_numpy(hyp),
                            "score": float(final),
                            "positional_scores": torch.from_numpy(pos)})
                if len(finalized[sent]) == beam or step == max_len:
                    finished[sent] = True
            if all(finished):
                break

            # fairseq's active_mask trick: penalize EOS'd / ignored slots,
            # keep the `beam` smallest (the best remaining candidates)
            cand_size = cand_scores.shape[1]
            eos_mask[:, :beam] |= cands_to_ignore
            active_mask = (eos_mask.astype(np.int64) * cand_size
                           + np.arange(cand_size)[None])
            active_hypos = np.argsort(active_mask, axis=1,
                                      kind="stable")[:, :beam]
            cands_to_ignore = np.take_along_axis(active_mask, active_hypos,
                                                 axis=1) >= cand_size
            active_rows = np.take_along_axis(cand_rows, active_hypos, axis=1)
            active_scores = np.take_along_axis(cand_scores, active_hypos,
                                               axis=1)
            active_tokens = np.take_along_axis(cand_tokens, active_hypos,
                                               axis=1)

            reorder = active_rows.reshape(-1)
            tokens[:, : step + 1] = tokens[reorder, : step + 1]
            tokens[:, step + 1] = active_tokens.reshape(-1)
            if step > 0:
                scores[:, :step] = scores[reorder, :step]
            scores[:, step] = active_scores.reshape(-1)
            order = torch.as_tensor(reorder, device=device).long()
            caches = [m.reorder_cache(c, order)
                      for m, c in zip(self.members, caches)]

        for sent in range(bsz):
            finalized[sent].sort(key=lambda h: -h["score"])
        return finalized

    # --------------------------------------------------- the device search

    @torch.inference_mode()
    def generate_on_device(self, encoder_out, encoder_padding_mask=None,
                           bos_token=None):
        """``generate()`` with the whole search on the device
        (``fairseq_generator.py:345``): the same hypotheses as the host
        loop for one decoder without an LM. A step reads one scalar, all
        finished or not; the finalized buffers are read once at the end."""
        if self.lm is not None:
            raise ValueError("generate_on_device: LM fusion is host-side; "
                             "use generate()")
        if self.vocab_size - 2 < 2 * self.beam_size:
            raise ValueError("generate_on_device needs vocab-2 >= 2*beam "
                             "(finite top-2*beam under pad/eos masking)")
        if len(self.members) > 1:
            raise ValueError("generate_on_device: ensembles are host-side; "
                             "use generate()")
        beam, pad, eos = self.beam_size, self.pad, self.eos
        decoder = self.decoder
        device = encoder_out.device
        max_len = self._max_len(encoder_out)
        bos = self.eos if bos_token is None else bos_token
        self.stats = {"steps": 0, "host_reads": 0}
        bsz = int(encoder_out.shape[0])
        rows_n, length, ml1 = bsz * beam, max_len + 2, max_len + 1
        cache = decoder.init_cache(encoder_out, length,
                                   encoder_padding_mask=encoder_padding_mask,
                                   beam=beam)
        longs = dict(dtype=torch.long, device=device)
        sent_of = torch.arange(bsz, **longs)[:, None]
        col_len = torch.arange(length, **longs)
        col_ml1 = torch.arange(ml1, **longs)
        slots = torch.arange(beam, **longs)
        cand_ix = torch.arange(2 * beam, **longs)[None, :]

        tokens = torch.full((rows_n, length), pad, **longs)
        tokens[:, 0] = bos
        scores = torch.zeros(rows_n, ml1, device=device)
        ignore = torch.zeros(bsz, beam, dtype=torch.bool, device=device)
        finished = torch.zeros(bsz, dtype=torch.bool, device=device)
        n_fin = torch.zeros(bsz, **longs)
        fin_tok = torch.full((bsz, beam, length), pad, **longs)
        fin_scr = torch.zeros(bsz, beam, device=device)
        fin_raw = torch.zeros(bsz, beam, ml1, device=device)
        fin_len = torch.zeros(bsz, beam, **longs)

        for step in range(max_len + 1):
            self.stats["steps"] += 1
            cum = (scores[:, step - 1] if step > 0
                   else torch.zeros(rows_n, device=device))
            lp = self._masked(self._log_probs(decoder, cache, tokens[:, step],
                                              step), step, max_len)
            v = lp.shape[-1]
            flat = (lp + cum[:, None]).reshape(bsz, beam * v)
            if step == 0:
                flat[:, v:] = -torch.inf
            cs, idx = _ranked(flat, 2 * beam)
            ct, cb = idx % v, idx // v
            cand_rows = cb + sent_of * beam

            # top-beam EOS finalization (host: for j in range(beam))
            eos_cand = (ct == eos) & (cs != -torch.inf)
            do_fin = eos_cand[:, :beam] & ~ignore & ~finished[:, None]
            slot = n_fin[:, None] + torch.cumsum(do_fin, dim=1) - 1
            accept = do_fin & (slot < beam)
            rows = cand_rows[:, :beam].reshape(-1)
            rows_tok = torch.where(col_len == step + 1, eos,
                                   tokens[rows]).reshape(bsz, beam, length)
            rows_scr = torch.where(
                col_ml1 == step, cs[:, :beam].reshape(-1, 1),
                scores[rows]).reshape(bsz, beam, ml1)
            final = cs[:, :beam]
            if self.normalize_scores:
                final = final / torch.tensor(
                    np.float32((step + 1) ** self.len_penalty),
                    device=device)
            onehot = accept[:, :, None] & (slot[:, :, None] == slots)
            sel = onehot.any(dim=1)
            fin_tok = torch.where(
                sel[:, :, None],
                (onehot[..., None] * rows_tok[:, :, None, :]).sum(1),
                fin_tok)
            fin_raw = torch.where(
                sel[:, :, None],
                (onehot[..., None] * rows_scr[:, :, None, :]).sum(1),
                fin_raw)
            fin_scr = torch.where(sel, (onehot * final[:, :, None]).sum(1),
                                  fin_scr)
            fin_len = torch.where(sel, step + 1, fin_len)
            n_fin = n_fin + accept.sum(dim=1)
            finished = finished | (n_fin == beam)
            if step == max_len:
                break
            if bool(self._read(finished.all())):
                break

            # survivors: beam smallest of the eos/ignore-penalized rank
            eos_pen = eos_cand.clone()
            eos_pen[:, :beam] |= ignore
            active_mask = eos_pen.long() * (2 * beam) + cand_ix
            active_hypos = torch.sort(active_mask, dim=1,
                                      stable=True)[1][:, :beam]
            ignore = active_mask.gather(1, active_hypos) >= 2 * beam
            reorder = cand_rows.gather(1, active_hypos).reshape(-1)
            tokens = tokens[reorder]
            tokens[:, step + 1] = ct.gather(1, active_hypos).reshape(-1)
            scores = scores[reorder]
            scores[:, step] = cs.gather(1, active_hypos).reshape(-1)
            cache = decoder.reorder_cache(cache, reorder)

        n_fin, fin_tok, fin_scr, fin_raw, fin_len = (
            self._read(t) for t in (n_fin, fin_tok, fin_scr, fin_raw,
                                    fin_len))
        finalized = []
        for sent in range(bsz):
            hyps = []
            for s in range(int(n_fin[sent])):
                ln = int(fin_len[sent, s])      # hyp length incl. final EOS
                pos = fin_raw[sent, s, :ln].copy()
                pos[1:] -= pos[:-1].copy()
                hyps.append({
                    "tokens": torch.from_numpy(
                        fin_tok[sent, s, 1: ln + 1].astype(np.int32)),
                    "score": float(fin_scr[sent, s]),
                    "positional_scores": torch.from_numpy(pos)})
            hyps.sort(key=lambda h: -h["score"])
            finalized.append(hyps)
        return finalized
