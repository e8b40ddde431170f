"""HMM forced alignment (port of ``svt_speechbrain_tpu/alignment/aligner.py``,
the analogue of SpeechBrain's ``alignment/aligner.py`` ``HMMAligner``).

Left-to-right HMM over the phoneme sequence with self-loops and forward
transitions: masked per-frame emission gathers, the pi/transition
log-softmax construction, the forward DP that freezes finished rows via a
self-loop identity, Viterbi backtrace from the chosen final state, lexicon
pronunciation graphs with optional inter-word silences, and the
flat-start → store → retrieve Viterbi-training loop.

The DPs run in float64 on the device of the emissions, where the JAX
package runs numpy f64 on the host: a step a frame, each a batched
(B, U, U) log-space product. The Viterbi backtrace reads the score matrix
and the backpointers to the host in one copy, then walks them there. The
lexicon graphs are built on the host (numpy) and the DP takes them to the
device. Ties go to the lower index (``argmax`` keeps the first maximum).
Stored alignments are numpy int16 arrays, pickled by ``_save`` in the JAX
aligner's format, so that either package's file loads in the other.
"""
from __future__ import annotations

import collections
import itertools
import pickle
import random

import numpy as np
import torch

from svt_speechbrain_tpu_torch.utils.checkpoints import (
    mark_as_loader, mark_as_saver, register_checkpoint_hooks)


def _np_log_softmax(x, axis):
    """The JAX aligner's host log-softmax: an all -inf row gives NaN,
    which the callers overwrite with ``neg_inf``."""
    m = np.max(x, axis=axis, keepdims=True)
    m = np.where(np.isfinite(m), m, 0.0)
    z = x - m
    with np.errstate(over="ignore", divide="ignore"):
        lse = np.log(np.sum(np.exp(z), axis=axis, keepdims=True))
    return z - lse


def _log_softmax(x, dim):
    """``_np_log_softmax`` in torch, on ``x``'s device."""
    m = x.amax(dim=dim, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    z = x - m
    return z - torch.log(torch.exp(z).sum(dim=dim, keepdim=True))


def _f64(x, device=None):
    return torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x,
                           device=device).to(torch.float64)


def _abs_lens(lens, size, device):
    """round(size · relative length) as int64 on ``device``, the product
    in the lengths' own dtype (as numpy forms it)."""
    lens = torch.as_tensor(lens if torch.is_tensor(lens) else np.asarray(lens),
                           device=device)
    return torch.round(size * lens).to(torch.int64)


@register_checkpoint_hooks
class HMMAligner:
    """Viterbi/forward alignment over batched emission posteriors
    (``aligner.py:42``). See ``forward`` for the main entry.

    Example
    -------
    >>> import torch
    >>> emission = torch.full((1, 9, 5), -10.0)
    >>> truth = [0, 0, 0, 1, 1, 1, 2, 2, 2]
    >>> phn_ids = [3, 1, 4]
    >>> for t, seg in enumerate(truth):
    ...     emission[0, t, phn_ids[seg]] = 0.0
    >>> aligner = HMMAligner()
    >>> scores, alignments = aligner.forward(
    ...     emission, torch.tensor([1.0]), torch.tensor([phn_ids]),
    ...     torch.tensor([1.0]), dp_algorithm="viterbi")
    >>> alignments
    [[3, 3, 3, 1, 1, 1, 4, 4, 4]]
    >>> forward_scores = aligner.forward(
    ...     emission, torch.tensor([1.0]), torch.tensor([phn_ids]),
    ...     torch.tensor([1.0]), dp_algorithm="forward")
    >>> bool(forward_scores[0] >= scores[0])   # sum over paths >= best path
    True
    """

    def __init__(self, states_per_phoneme=1, output_folder="", neg_inf=-1e5,
                 batch_reduction="none", input_len_norm=False,
                 target_len_norm=False, lexicon_path=None):
        self.states_per_phoneme = states_per_phoneme
        self.output_folder = output_folder
        self.neg_inf = neg_inf
        self.batch_reduction = batch_reduction
        self.input_len_norm = input_len_norm
        self.target_len_norm = target_len_norm
        self.align_dict = {}
        self.lexicon_path = lexicon_path
        if lexicon_path is not None:
            self._load_lexicon(lexicon_path)

    # ------------------------------------------------------------- lexicon

    def _load_lexicon(self, lexicon_path):
        """Parse a CMU-style lexicon file: ``word/phones/`` lines, a leading
        block of ``;`` comments, ``~``-suffixed pronunciation variants keyed
        back to the headword, stress digits stripped (``aligner.py:85``)."""
        with open(lexicon_path) as f:
            entries = itertools.dropwhile(
                lambda ln: ln[:1] == ";", f.read().splitlines())
        pronunciations = collections.defaultdict(list)
        inventory = set()
        for entry in entries:
            headword = entry.split()[0].partition("~")[0]
            phones = "".join(c for c in entry.split("/")[1] if not c.isdigit())
            inventory.update(phones.split(" "))
            pronunciations[headword].append(phones)
        self.lexicon = {w: dict(enumerate(ps))
                        for w, ps in pronunciations.items()}
        ranked = sorted(inventory)
        self.lex_lab2ind = {p: i for i, p in enumerate(ranked, start=1)}
        self.lex_ind2lab = {i: p for i, p in enumerate(ranked, start=1)}
        # "sil" is reserved index 0; it never appears in lexicon files.
        self.lex_lab2ind["sil"] = 0
        self.lex_ind2lab[0] = "sil"

    def _use_lexicon(self, words, interword_sils, sample_pron):
        """One utterance's pronunciation graph (``aligner.py:109``), on the
        host: optional silences, all (or one sampled) pronunciation(s) per
        word, self-loops + within-pronunciation chains + word→word links,
        row log-softmax. ``sample_pron`` shuffles with Python's global
        ``random``. Returns (poss_phns, log_trans, start_states,
        final_states)."""
        spp = self.states_per_phoneme
        state_phn = []

        def alloc(label):
            base = len(state_phn)
            state_phn.extend(label * spp + k for k in range(spp))
            return list(range(base, base + spp))

        def pron_chain(phones):
            return [s for p in phones.split()
                    for s in alloc(self.lex_lab2ind[p])]

        segments = [([alloc(self.silence_index)], True)]
        for word in words:
            prons = self.lexicon[word]
            if sample_pron and len(prons) > 1:
                random.shuffle(prons)  # int-keyed dict: in-place value swap
            take = 1 if sample_pron else len(prons)
            segments.append(
                ([pron_chain(prons[k]) for k in range(take)], False))
            if interword_sils:
                segments.append(([alloc(self.silence_index)], True))
        if not interword_sils:
            segments.append(([alloc(self.silence_index)], True))

        trans = np.eye(len(state_phn))
        final_states = []
        for i, (chains, is_sil) in enumerate(segments):
            for chain in chains:
                trans[chain[:-1], chain[1:]] = 1.0
            lasts = [chain[-1] for chain in chains]
            if i < len(segments) - 2:
                fwd = i + 1 if is_sil or not interword_sils else i + 2
                starts = [chain[0] for chain in segments[fwd][0]]
                trans[np.ix_(lasts, starts)] = 1.0
            else:
                final_states += lasts
            if not is_sil:
                trans[lasts, segments[i + 1][0][0][0]] = 1.0

        with np.errstate(divide="ignore"):
            log_transition_matrix = _np_log_softmax(np.log(trans), axis=1)
        start_states = ([segments[0][0][0][0]]
                        + [chain[0] for chain in segments[1][0]])
        return (np.asarray(state_phn), log_transition_matrix,
                start_states, final_states)

    def use_lexicon(self, words, interword_sils=True, sample_pron=False):
        """Batch of pronunciation graphs (``aligner.py:169``): returns
        (poss_phns (B, U) int64, poss_phn_lens relative f64, trans_prob
        (B, U, U) f64, pi_prob (B, U) f64, final_states per utterance), the
        tensors on the CPU (``forward`` takes them to the emissions'
        device)."""
        self.silence_index = self.lex_lab2ind["sil"]
        poss_phns, trans_prob, start_states, final_states = [], [], [], []
        for words_ in words:
            p, t, s, f = self._use_lexicon(words_, interword_sils, sample_pron)
            poss_phns.append(p)
            trans_prob.append(t)
            start_states.append(s)
            final_states.append(f)

        poss_phn_lens = [len(p) for p in poss_phns]
        u_max = max(poss_phn_lens)
        batch_size = len(poss_phns)
        for i in range(batch_size):
            pad = u_max - len(poss_phns[i])
            poss_phns[i] = np.pad(poss_phns[i], (0, pad))
            trans_prob[i] = np.pad(trans_prob[i], ((0, pad), (0, pad)),
                                   constant_values=self.neg_inf)
        poss_phns = np.stack(poss_phns)
        trans_prob = np.stack(trans_prob)
        trans_prob[trans_prob == -np.inf] = self.neg_inf

        pi_prob = self.neg_inf * np.ones([batch_size, u_max])
        # as the reference: every utterance's start states mark ALL rows
        for start_state in start_states:
            pi_prob[:, start_state] = 1
        pi_prob = _np_log_softmax(pi_prob, axis=1)
        poss_phn_lens = np.asarray(poss_phn_lens, np.float64) / u_max
        return (torch.from_numpy(poss_phns.astype(np.int64)),
                torch.from_numpy(poss_phn_lens), torch.from_numpy(trans_prob),
                torch.from_numpy(pi_prob), final_states)

    # -------------------------------------------------------- prob tensors

    def _make_pi_prob(self, phn_lens_abs, u_max):
        """All initial mass on the first phoneme (``aligner.py:204``)."""
        pi_prob = torch.full((len(phn_lens_abs), u_max), float(self.neg_inf),
                             dtype=torch.float64, device=phn_lens_abs.device)
        pi_prob[:, 0] = 0
        return pi_prob

    def _make_trans_prob(self, phn_lens_abs, u_max):
        """Self-loop + next-phoneme transitions, length-masked, row
        log-softmax with NaN/-inf → neg_inf (``aligner.py:212``)."""
        device = phn_lens_abs.device
        eye = torch.eye(u_max, dtype=torch.float64, device=device)
        trans = (eye + torch.diag(torch.ones(u_max - 1, dtype=torch.float64,
                                             device=device), 1))
        valid = (torch.arange(u_max, device=device)[None, :]
                 < phn_lens_abs[:, None])
        mask = valid[:, :, None] & valid[:, None, :]
        trans = trans[None] * mask
        trans = torch.where(trans == 1, trans,
                            torch.full_like(trans, -float("inf")))
        trans = _log_softmax(trans, dim=2)
        bad = torch.isnan(trans) | (trans == -float("inf"))
        return torch.where(bad, torch.full_like(trans, float(self.neg_inf)),
                           trans)

    def _make_emiss_pred_useful(self, emission_pred, lens_abs, phn_lens_abs,
                                phns, u_max, t_max):
        """Gather the per-frame posteriors of each phn-sequence position:
        frames past ``lens_abs`` contribute 0, positions past
        ``phn_lens_abs`` neg_inf; → (B, U, T) (``aligner.py:230``)."""
        device = emission_pred.device
        mask_lens = (torch.arange(t_max, device=device)[None, :]
                     < lens_abs[:, None])
        emiss = torch.where(mask_lens[:, :, None], emission_pred[:, :t_max],
                            torch.zeros((), dtype=torch.float64,
                                        device=device))
        index = phns[:, None, :].expand(emiss.shape[0], emiss.shape[1],
                                        phns.shape[1])
        gathered = torch.gather(emiss, 2, index)
        mask_phn = (torch.arange(phns.shape[1], device=device)[None, :]
                    < phn_lens_abs[:, None])
        gathered = torch.where(mask_phn[:, None, :], gathered,
                               torch.full((), float(self.neg_inf),
                                          dtype=torch.float64, device=device))
        return gathered[:, :, :u_max].permute(0, 2, 1)

    # ----------------------------------------------------------------- DP

    def _dp_forward(self, pi_prob, trans_prob, emiss_pred_useful, lens_abs,
                    t_max):
        """Forward algorithm (``aligner.py:250``) on the device, a step a
        frame; a finished utterance's transitions become a 0-logprob
        self-loop identity, as the reference's."""
        u_max = pi_prob.shape[1]
        identity = torch.full((u_max, u_max), float(self.neg_inf),
                              dtype=torch.float64, device=pi_prob.device)
        identity.fill_diagonal_(0.0)
        trans_t = trans_prob.transpose(1, 2)
        alpha = pi_prob + emiss_pred_useful[:, :, 0]
        for t in range(1, t_max):
            passed = (lens_abs < t)[:, None, None]
            trans_t = torch.where(passed, identity, trans_t)
            # logsumexp_j(trans[j, i] + alpha[j]) per row i
            scores = trans_t + alpha[:, None, :]
            m = scores.amax(dim=2, keepdim=True)
            m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
            alpha = (m[..., 0] + torch.log(torch.exp(scores - m).sum(dim=2))
                     + emiss_pred_useful[:, :, t])
        top = alpha.amax(dim=1, keepdim=True)
        return torch.log(torch.exp(alpha - top).sum(dim=1)) + top[:, 0]

    def _dp_viterbi(self, pi_prob, trans_prob, emiss_pred_useful, lens_abs,
                    phn_lens_abs, phns, final_states, t_max):
        """Viterbi with backtrace from the last in-length frame
        (``aligner.py:277``): the max-plus steps on the device, then the
        score matrix, backpointers, lengths and phonemes read to the host
        once for the backtrace. Returns (z_stars, z_stars_loc, scores on
        the device)."""
        batch_size = pi_prob.shape[0]
        v = pi_prob + emiss_pred_useful[:, :, 0]
        v_hist = [v]
        backpointers = [torch.zeros_like(v, dtype=torch.int64)]
        trans_t = trans_prob.transpose(1, 2)
        for t in range(1, t_max):
            scores = trans_t + v[:, None, :]
            backpointers.append(scores.argmax(dim=2))
            v = scores.amax(dim=2) + emiss_pred_useful[:, :, t]
            v_hist.append(v)
        v_matrix = torch.stack(v_hist, dim=2)               # (B, U, T)
        rows = torch.arange(batch_size, device=v_matrix.device)
        viterbi_scores = v_matrix[rows, phn_lens_abs - 1, lens_abs - 1]
        host = [x.cpu().numpy() for x in (
            v_matrix, torch.stack(backpointers, dim=2), lens_abs,
            phn_lens_abs, phns)]
        v_np, bp_np, lens_np, phn_lens_np, phns_np = host

        z_stars, z_stars_loc = [], []
        for b in range(batch_size):
            len_abs = int(lens_np[b])
            if final_states is not None:
                finals = list(final_states[b])
                u = finals[int(np.argmax(v_np[b, finals, len_abs - 1]))]
            else:
                u = int(phn_lens_np[b]) - 1
            loc = [u]
            z_star = [int(phns_np[b, u])]
            for time_step in range(len_abs, 1, -1):
                earlier = int(bp_np[b, loc[0], time_step - 1])
                loc.insert(0, earlier)
                z_star.insert(0, int(phns_np[b, earlier]))
            z_stars.append(z_star)
            z_stars_loc.append(loc)
        return z_stars, z_stars_loc, viterbi_scores

    def _loss_reduction(self, loss, input_lens, target_lens):
        """Optional length normalization + batch reduction
        (``aligner.py:321``)."""
        if self.input_len_norm:
            loss = loss / input_lens
        if self.target_len_norm:
            loss = loss / target_lens
        if self.batch_reduction == "none":
            return loss
        if self.batch_reduction == "sum":
            return loss.sum()
        if self.batch_reduction == "mean":
            return loss.mean()
        raise ValueError(
            "`batch_reduction` parameter must be one of 'none', 'sum' or "
            "'mean'")

    def forward(self, emission_pred, lens, phns, phn_lens, dp_algorithm,
                prob_matrices=None):
        """Main entry (``aligner.py:337``): relative lengths → DP, in f64
        on ``emission_pred``'s device. ``dp_algorithm`` "forward" returns
        per-utterance log-likelihoods (a tensor); "viterbi" returns (scores,
        alignments as lists). ``prob_matrices`` overrides {pi_prob,
        trans_prob, final_states} (the ``use_lexicon`` path)."""
        emission_pred = _f64(emission_pred)
        device = emission_pred.device
        lens_abs = _abs_lens(lens, emission_pred.shape[1], device)
        phns = torch.as_tensor(phns if torch.is_tensor(phns)
                               else np.asarray(phns), device=device)
        phn_lens_abs = _abs_lens(phn_lens, phns.shape[1], device)
        phns = phns.to(torch.int64)
        u_max, t_max = (int(v) for v in torch.stack(
            [phn_lens_abs.max(), lens_abs.max()]).tolist())

        if prob_matrices is None:
            pi_prob = self._make_pi_prob(phn_lens_abs, u_max)
            trans_prob = self._make_trans_prob(phn_lens_abs, u_max)
            final_states = None
        else:
            pi_prob = _f64(prob_matrices["pi_prob"], device)
            trans_prob = _f64(prob_matrices["trans_prob"], device)
            final_states = prob_matrices["final_states"]

        emiss = self._make_emiss_pred_useful(emission_pred, lens_abs,
                                             phn_lens_abs, phns, u_max, t_max)
        if dp_algorithm == "forward":
            scores = self._dp_forward(pi_prob, trans_prob, emiss, lens_abs,
                                      t_max)
            return self._loss_reduction(scores, lens_abs, phn_lens_abs)
        if dp_algorithm == "viterbi":
            alignments, _, scores = self._dp_viterbi(
                pi_prob, trans_prob, emiss, lens_abs, phn_lens_abs, phns,
                final_states, t_max)
            return self._loss_reduction(scores, lens_abs, phn_lens_abs), \
                alignments
        raise ValueError(
            "dp_algorithm input must be either 'forward' or 'viterbi'")

    __call__ = forward

    # ------------------------------------------------- alignment bookkeeping

    def expand_phns_by_states_per_phoneme(self, phns, phn_lens):
        """id → [spp·id .. spp·id + spp-1] per phoneme (``aligner.py:377``),
        as an f64 tensor on ``phns``' device."""
        device = phns.device if torch.is_tensor(phns) else None
        phns = np.asarray(phns.cpu() if torch.is_tensor(phns) else phns)
        phn_lens = np.asarray(phn_lens.cpu() if torch.is_tensor(phn_lens)
                              else phn_lens)
        spp = self.states_per_phoneme
        expanded = np.zeros((phns.shape[0], phns.shape[1] * spp))
        phn_lens_abs = np.round(phns.shape[1] * phn_lens).astype(np.int64)
        for i in range(phns.shape[0]):
            utt = phns[i, : phn_lens_abs[i]].astype(np.int64)
            flat = [spp * p + j for p in utt for j in range(spp)]
            expanded[i, : len(flat)] = flat
        return torch.from_numpy(expanded).to(device)

    def store_alignments(self, ids, alignments):
        """Record Viterbi alignments as numpy int16 arrays, for Viterbi
        training (``aligner.py:390``)."""
        for i, utt_id in enumerate(ids):
            align = alignments[i]
            if torch.is_tensor(align):
                align = align.cpu().numpy()
            self.align_dict[utt_id] = np.asarray(align, np.int16)

    @staticmethod
    def _get_flat_start_batch(lens_abs, phn_lens_abs, phns):
        """Equal-duration flat-start alignments (``aligner.py:395``), on
        the host."""
        phns = np.asarray(phns, np.int64)
        batch_size = len(lens_abs)
        t_max = int(np.max(lens_abs))
        out = np.zeros((batch_size, t_max), np.int64)
        for i in range(batch_size):
            utt = phns[i, : int(phn_lens_abs[i])]
            repeat_amt = max(int(int(lens_abs[i]) / len(utt)), 1)
            utt = np.repeat(utt, repeat_amt)[: int(lens_abs[i])]
            if len(utt) < int(lens_abs[i]):
                utt = np.pad(utt, (0, int(lens_abs[i]) - len(utt)),
                             constant_values=utt[-1])
            out[i, : len(utt)] = utt
        return out

    def _get_viterbi_batch(self, ids, lens_abs):
        """Zero-padded batch of stored alignments (``aligner.py:411``)."""
        t_max = int(np.max(lens_abs))
        out = np.zeros((len(ids), t_max), np.int64)
        for i, utt_id in enumerate(ids):
            preds = np.asarray(self.align_dict[utt_id], np.int64)
            out[i, : len(preds)] = preds
        return out

    def get_prev_alignments(self, ids, emission_pred, lens, phns, phn_lens):
        """Stored Viterbi alignments if available, else flat start
        (``aligner.py:420``), as an int64 tensor on ``emission_pred``'s
        device.

        Example
        -------
        >>> import torch
        >>> aligner = HMMAligner()
        >>> emission_pred = torch.zeros(1, 6, 3)
        >>> aligner.get_prev_alignments(
        ...     ["utt1"], emission_pred, torch.tensor([1.0]),
        ...     torch.tensor([[0, 1, 2]]), torch.tensor([1.0]))
        tensor([[0, 0, 1, 1, 2, 2]])
        >>> aligner.store_alignments(["utt1"], [[0, 1, 1, 1, 2, 2]])
        >>> aligner.get_prev_alignments(
        ...     ["utt1"], emission_pred, torch.tensor([1.0]),
        ...     torch.tensor([[0, 1, 2]]), torch.tensor([1.0]))
        tensor([[0, 1, 1, 1, 2, 2]])
        """
        device = emission_pred.device if torch.is_tensor(emission_pred) \
            else None
        lens_abs = _abs_lens(lens, emission_pred.shape[1], "cpu").numpy()
        phns = torch.as_tensor(phns if torch.is_tensor(phns)
                               else np.asarray(phns)).cpu()
        phn_lens_abs = _abs_lens(phn_lens, phns.shape[1], "cpu").numpy()
        if ids[0] in self.align_dict:
            out = self._get_viterbi_batch(ids, lens_abs)
        else:
            out = self._get_flat_start_batch(lens_abs, phn_lens_abs,
                                             phns.numpy())
        return torch.from_numpy(out).to(device)

    # --------------------------------------------------------- evaluation

    def _calc_accuracy_sent(self, alignments_, ends_, phns_):
        """Sample-level accuracy for one utterance (``aligner.py:452``)."""
        ends_ = [0] + [int(end) for end in ends_]
        durations = [ends_[i] - ends_[i - 1] for i in range(1, len(ends_))]
        true_alignments = np.concatenate(
            [np.full(d, p) for p, d in zip(phns_, durations)])
        upsample = int(round(len(true_alignments) / len(alignments_)))
        upsampled = np.repeat(np.asarray(alignments_), upsample)
        upsampled = upsampled[: len(true_alignments)]
        if len(true_alignments) > len(upsampled):
            upsampled = np.pad(upsampled,
                               (0, len(true_alignments) - len(upsampled)))
        return float((upsampled == true_alignments).mean() * 100)

    def calc_accuracy(self, alignments, ends, phns, ind2labs=None):
        """Mean sample-level accuracy against ground-truth phoneme ends
        (``aligner.py:466``), as a length-1 f64 tensor. With ``ind2labs``
        both sides are first mapped onto their labels' shared index space
        (``map_inds_to_intersect``; the JAX aligner unpacks its three
        results into two and raises, ROADMAP.md queue 3).

        Example
        -------
        >>> aligner = HMMAligner()
        >>> float(aligner.calc_accuracy([[0., 0., 0., 1.]], [[2, 4]],
        ...                             [[0., 1.]])[0])
        75.0
        """
        if self.states_per_phoneme > 1:
            alignments = [[i // self.states_per_phoneme for i in utt]
                          for utt in alignments]
        if ind2labs is not None:
            alignments, phns, _ = map_inds_to_intersect(alignments, phns,
                                                        ind2labs)
        accs = [self._calc_accuracy_sent(a, e, p)
                for a, e, p in zip(alignments, ends, phns)]
        return torch.tensor([np.mean(accs)], dtype=torch.float64)

    def collapse_alignments(self, alignments):
        """Multi-state alignments → 1-state-per-phoneme (``aligner.py:487``).

        Example
        -------
        >>> aligner = HMMAligner(states_per_phoneme=3)
        >>> aligner.collapse_alignments([0, 1, 2, 3, 4, 5, 3, 4, 5, 0, 1, 2])
        [0, 1, 1, 0]
        """
        sequence = [v for i, v in enumerate(alignments)
                    if i == 0 or v != alignments[i - 1]]
        sequence = [v for v in sequence
                    if v % self.states_per_phoneme == 0]
        return [v // self.states_per_phoneme for v in sequence]

    # -------------------------------------------------------- persistence

    @mark_as_saver
    def _save(self, path):
        with open(path, "wb") as f:
            pickle.dump({k: np.asarray(v) for k, v in self.align_dict.items()},
                        f)

    @mark_as_loader
    def _load(self, path, end_of_epoch=False, device=None):
        del end_of_epoch, device
        with open(path, "rb") as f:
            self.align_dict = pickle.load(f)

    # -------------------------------------------------------- convenience

    def align(self, emission_lp, phns):
        """Single-utterance Viterbi (``aligner.py:518``): emission_lp (T, V),
        phns (U,) → (per-frame phoneme-position path (T,) numpy, score)."""
        emission_lp = _f64(emission_lp)
        device = emission_lp.device
        lens_abs = torch.tensor([emission_lp.shape[0]], device=device)
        phn_lens_abs = torch.tensor([len(phns)], device=device)
        phns_b = torch.as_tensor(np.asarray([phns], np.int64), device=device)
        u_max, t_max = len(phns), emission_lp.shape[0]
        _, locs, scores = self._dp_viterbi(
            self._make_pi_prob(phn_lens_abs, u_max),
            self._make_trans_prob(phn_lens_abs, u_max),
            self._make_emiss_pred_useful(emission_lp[None], lens_abs,
                                         phn_lens_abs, phns_b, u_max, t_max),
            lens_abs, phn_lens_abs, phns_b, None, t_max)
        return np.asarray(locs[0]), float(scores[0])


def batch_log_matvecmul(A, b):
    """Log-space matrix × vector: out[i] = logsumexp_j(A[ij] + b[j]),
    batched (``aligner.py:534``).

    Example
    -------
    >>> import torch
    >>> A = torch.log(torch.tensor([[[0.5, 0.5], [0.25, 0.75]]]))
    >>> b = torch.log(torch.tensor([[0.5, 0.5]]))
    >>> torch.exp(batch_log_matvecmul(A, b)).round(decimals=3)
    tensor([[0.5000, 0.5000]])
    """
    return torch.logsumexp(A + b[:, None, :], dim=-1)


def batch_log_maxvecmul(A, b):
    """Max-plus matrix × vector with argmax, batched (``aligner.py:549``):
    returns (max values, argmax indices), ties to the lower index.

    Example
    -------
    >>> import torch
    >>> A = torch.log(torch.tensor([[[0.5, 0.5], [0.25, 0.75]]]))
    >>> b = torch.log(torch.tensor([[0.5, 0.5]]))
    >>> v, idx = batch_log_maxvecmul(A, b)
    >>> torch.exp(v).round(decimals=3), idx
    (tensor([[0.2500, 0.3750]]), tensor([[0, 1]]))
    """
    scores = A + b[:, None, :]
    return scores.amax(dim=-1), scores.argmax(dim=-1)


def map_inds_to_intersect(lists1, lists2, ind2labs):
    """Map two index-sequence lists onto a shared label-intersection index
    space (``aligner.py:568``). Returns (mapped1, mapped2, new_lab2ind)."""
    ind2lab1, ind2lab2 = ind2labs
    labs = sorted(set(ind2lab1.values()) | set(ind2lab2.values()))
    new_lab2ind = {lab: i for i, lab in enumerate(labs)}
    mapped1 = [[new_lab2ind[ind2lab1[i]] for i in seq] for seq in lists1]
    mapped2 = [[new_lab2ind[ind2lab2[i]] for i in seq] for seq in lists2]
    return mapped1, mapped2, new_lab2ind
