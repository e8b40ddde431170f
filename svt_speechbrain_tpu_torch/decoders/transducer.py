"""Transducer decoding (port of
``svt_speechbrain_tpu/decoders/transducer.py``).

The search logic is the JAX package's, which is golden-tested against the
original reference: greedy emits at most ONE symbol per frame (updating the
prediction network only for rows that emitted), and the beam search mirrors
Saon et al.'s state/expand-beam pruning exactly — normalized-score
hypothesis selection but RAW-score state-beam comparison, the blank-aware
``best_logp``, the expand-beam gate, and the 4-tuple return contract
``(best_hyps, exp-mean score, nbest, nbest_scores)``. The networks run on
the device of ``tn_output``; the search itself is host code on numpy copies
of each step's log-probabilities.
"""
from __future__ import annotations

import numpy as np
import torch


def _select_rows(mask, new, old):
    """Row by row, ``new`` where ``mask`` (B,) else ``old``, through a state
    of tensors nested in lists and tuples."""
    if isinstance(new, (list, tuple)):
        return type(new)(_select_rows(mask, n, o) for n, o in zip(new, old))
    if new is None:
        return None
    return torch.where(mask.reshape((-1,) + (1,) * (new.dim() - 1)), new, old)


class TransducerBeamSearcher:
    """Greedy (beam=1) and beam transducer search (``:21``).

    Functional adapter in place of the reference's module lists:
    ``decode_fn(tokens, state) → (dec_out, state)`` runs the prediction
    network one step; ``joint_fn(enc_frame, dec_out) → logits`` the joint
    (+ classifier head); optional ``lm_fn(tokens, state) → (log_probs,
    state)`` for shallow fusion like the reference's ``lm_module``.

    Example
    -------
    >>> import torch
    >>> from torch.nn.functional import one_hot
    >>> V = 4   # vocab with blank_id=0
    >>> def decode_fn(tokens, state):      # suppress the last-emitted token
    ...     return -10.0 * one_hot(tokens, V), None
    >>> def joint_fn(enc_frame, dec_out):
    ...     return enc_frame + dec_out
    >>> enc = 5.0 * one_hot(torch.tensor([[2, 1, 0]]), V)  # (1, 3, V)
    >>> searcher = TransducerBeamSearcher(decode_fn, joint_fn, blank_id=0,
    ...                                   beam_size=1)
    >>> hyps = searcher(enc)[0]
    >>> hyps
    [[2, 1]]
    >>> TransducerBeamSearcher(decode_fn, joint_fn, blank_id=0,
    ...                        beam_size=2)(enc)[0]
    [[2, 1]]
    """

    def __init__(self, decode_fn, joint_fn, blank_id, beam_size=4,
                 nbest=5, lm_fn=None, lm_weight=0.0,
                 state_beam=2.3, expand_beam=2.3, lm_module=None):
        self.decode_fn = decode_fn
        self.joint_fn = joint_fn
        self.blank_id = blank_id
        self.beam_size = beam_size
        self.nbest = nbest
        self.lm_fn = lm_fn if lm_fn is not None else lm_module
        self.lm_weight = lm_weight
        if lm_weight > 0 and self.lm_fn is None:
            raise ValueError("Language model is not provided.")
        self.state_beam = state_beam
        self.expand_beam = expand_beam
        if self.beam_size <= 1:
            self.searcher = self.transducer_greedy_decode
        else:
            self.searcher = self.transducer_beam_search_decode

    @torch.no_grad()
    def __call__(self, tn_output):
        return self.searcher(tn_output)

    def _log_probs(self, enc_frame, dec_out):
        """The joint's log-softmax as a host f32 array."""
        logits = self.joint_fn(enc_frame, dec_out)
        return torch.log_softmax(logits.detach(), dim=-1).float().cpu().numpy()

    def transducer_greedy_decode(self, tn_output):
        """Batched greedy: at most ONE symbol per frame; the prediction
        network advances only for rows that emitted (``:72``).
        Returns (predictions, exp-mean score, None, None)."""
        batch, dev = tn_output.shape[0], tn_output.device
        hyps = [[] for _ in range(batch)]
        logp_scores = np.zeros(batch)
        tokens = torch.full((batch,), self.blank_id, dtype=torch.long,
                            device=dev)
        dec_out, state = self.decode_fn(tokens, None)
        for t in range(tn_output.shape[1]):
            lp = self._log_probs(tn_output[:, t], dec_out)
            pred = lp.argmax(-1)
            nonblank = pred != self.blank_id
            for b in np.flatnonzero(nonblank):
                hyps[b].append(int(pred[b]))
                logp_scores[b] += lp[b, pred[b]]
            if nonblank.any():
                mask = torch.from_numpy(nonblank).to(dev)
                new_tokens = torch.where(mask, torch.from_numpy(pred).to(dev),
                                         tokens)
                new_dec, new_state = self.decode_fn(new_tokens, state)
                dec_out = torch.where(mask[:, None], new_dec, dec_out)
                state = (new_state if state is None
                         else _select_rows(mask, new_state, state))
                tokens = new_tokens
        return hyps, float(np.exp(logp_scores).mean()), None, None

    def transducer_beam_search_decode(self, tn_output):
        """Per-utterance beam search with state/expand-beam pruning
        (``:107``): normalized-score selection, RAW logp state-beam break
        (checked BEFORE popping a_best), blank-aware ``best_logp``,
        expand-beam gate. Returns (best_hyps, exp-mean score, nbest,
        nbest_scores)."""
        dev = tn_output.device

        def normalized(hyp):
            return hyp["logp_score"] / len(hyp["prediction"])

        nbest_batch, nbest_batch_score = [], []
        for i_batch in range(tn_output.shape[0]):
            hyp = {"prediction": [self.blank_id], "logp_score": 0.0,
                   "hidden_dec": None, "dec_out": None}
            if self.lm_weight > 0:
                hyp["hidden_lm"] = None
            beam_hyps = [hyp]
            for t_step in range(tn_output.shape[1]):
                process_hyps = beam_hyps
                beam_hyps = []
                while True:
                    if len(beam_hyps) >= self.beam_size:
                        break
                    if not process_hyps:
                        break
                    a_best_hyp = max(process_hyps, key=normalized)
                    if len(beam_hyps) > 0:
                        b_best_hyp = max(beam_hyps, key=normalized)
                        if (b_best_hyp["logp_score"]
                                >= self.state_beam + a_best_hyp["logp_score"]):
                            break
                    process_hyps.remove(a_best_hyp)
                    inp = torch.tensor([a_best_hyp["prediction"][-1]],
                                       dtype=torch.long, device=dev)
                    out_pn, hidden = self.decode_fn(
                        inp, a_best_hyp["hidden_dec"])
                    log_probs = self._log_probs(
                        tn_output[i_batch, t_step][None], out_pn).reshape(-1)
                    if self.lm_weight > 0:
                        log_probs_lm, hidden_lm = self.lm_fn(
                            inp, a_best_hyp.get("hidden_lm"))
                        log_probs_lm = torch.as_tensor(
                            log_probs_lm).detach().float().cpu().numpy(
                            ).reshape(-1)
                    positions = np.argsort(-log_probs,
                                           kind="stable")[: self.beam_size]
                    logp_targets = log_probs[positions]
                    best_logp = (logp_targets[0]
                                 if positions[0] != self.blank_id
                                 else logp_targets[1])
                    for j in range(len(positions)):
                        topk_hyp = {
                            "prediction": a_best_hyp["prediction"][:],
                            "logp_score": a_best_hyp["logp_score"]
                            + logp_targets[j],
                            "hidden_dec": a_best_hyp["hidden_dec"],
                        }
                        if self.lm_weight > 0:
                            topk_hyp["hidden_lm"] = a_best_hyp.get("hidden_lm")
                        if positions[j] == self.blank_id:
                            beam_hyps.append(topk_hyp)
                            continue
                        if logp_targets[j] >= best_logp - self.expand_beam:
                            topk_hyp["prediction"].append(int(positions[j]))
                            topk_hyp["hidden_dec"] = hidden
                            if self.lm_weight > 0:
                                topk_hyp["hidden_lm"] = hidden_lm
                                topk_hyp["logp_score"] += (
                                    self.lm_weight
                                    * log_probs_lm[positions[j]])
                            process_hyps.append(topk_hyp)
            nbest_hyps = sorted(beam_hyps, key=normalized,
                                reverse=True)[: self.nbest]
            all_predictions = [h["prediction"][1:] for h in nbest_hyps]
            all_scores = [normalized(h) for h in nbest_hyps]
            nbest_batch.append(all_predictions)
            nbest_batch_score.append(all_scores)
        return ([nb[0] for nb in nbest_batch],
                float(np.exp([s[0] for s in nbest_batch_score]).mean()),
                nbest_batch, nbest_batch_score)
