"""Port parity, the CTC decoders (``decoders/ctc.py``) and the speechbrain
seq2seq searchers (``decoders/seq2seq.py``) against the JAX package on the
CPU: greedy CTC decoding and its filter; chains of ``CTCPrefixScorer``
steps and ``permute_mem`` (full, partial, attention-windowed scoring);
``S2SGreedySearcher`` and ``S2SBeamSearcher`` driven in both packages by one
toy subclass whose ``forward_step`` reads seeded numpy tables (the next
token's log-probs and the attention depend on the step and the previous
token), over the beam searcher's options.

Tolerances: tokens and hypotheses exact; searcher scores within ATOL
(f32 scores of identical f32 inputs; the joint-CTC cases add float64 CTC
scores whose ``logaddexp`` may differ in the last bit); the scorer's
float64 state within CTC_RTOL relative (its -1e20 floor included).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from svt_speechbrain_tpu.decoders import ctc as jctc
from svt_speechbrain_tpu.decoders import seq2seq as js2s

from svt_speechbrain_tpu_torch.decoders import ctc as tctc
from svt_speechbrain_tpu_torch.decoders import seq2seq as ts2s

ATOL = 1e-5
CTC_RTOL = 1e-9
B, T, V, BEAM = 2, 6, 7, 3
BOS, EOS, BLANK = 0, 1, 2


def _log_softmax(a):
    a = a - a.max(axis=-1, keepdims=True)
    return (a - np.log(np.exp(a).sum(axis=-1, keepdims=True))).astype(
        np.float32)


def _np(x):
    return np.asarray(x.cpu() if torch.is_tensor(x) else x)


# ------------------------------------------------------------------ CTC

def test_filter_and_greedy_decode_match_jax():
    rng = np.random.default_rng(0)
    probs = rng.random((3, 9, 5)).astype(np.float32)
    probs[0, 2] = probs[0, 1]                    # a repeat to merge
    probs[1, :, 3] = 2.0                         # all blank
    lens = np.array([1.0, 0.5, 0.7222], np.float32)   # 0.5 · 9 rounds even
    for blank in (0, -1, 3):
        assert tctc.ctc_greedy_decode(torch.from_numpy(probs),
                                      torch.from_numpy(lens), blank) == \
            jctc.ctc_greedy_decode(probs, lens, blank)
    seq = [0, 0, 3, 3, 0, 1, 1, 4, 0]
    assert tctc.filter_ctc_output(seq, 0) == jctc.filter_ctc_output(seq, 0)
    with pytest.raises(ValueError):
        tctc.filter_ctc_output(np.array(seq), 0)


def _scorer_inputs(seed):
    rng = np.random.default_rng(seed)
    x = _log_softmax(rng.standard_normal((2, 8, 6)) * 2).astype(np.float64)
    attn = rng.random((4, 8))
    attn /= attn.sum(-1, keepdims=True)
    return x, np.array([8, 5]), attn


def _state_close(got, want):
    for g, w in zip(got, want):
        if w is None:
            assert g is None
            continue
        np.testing.assert_allclose(_np(g), np.asarray(w), rtol=CTC_RTOL,
                                   atol=0)


@pytest.mark.parametrize("mode", ["full", "partial", "window"])
def test_ctc_prefix_scorer_chain_matches_jax(mode):
    """Three steps of forward_step + permute_mem from the empty prefix."""
    x, lens, attn = _scorer_inputs(1)
    window = 2 if mode == "window" else 0
    js = jctc.CTCPrefixScorer(x, lens, 2, 2, BLANK, EOS, window)
    ts = tctc.CTCPrefixScorer(torch.from_numpy(x), torch.from_numpy(lens),
                              2, 2, BLANK, EOS, window)
    rng = np.random.default_rng(2)
    g = np.zeros((4, 0), np.int64)
    jstate = tstate = None
    for step in range(3):
        cands = (np.stack([rng.permutation(6)[:3] for _ in range(4)])
                 if mode == "partial" else None)
        a = attn if mode == "window" else None
        jpsi, jstate = js.forward_step(g, jstate, cands, a)
        tpsi, tstate_new = ts.forward_step(
            torch.from_numpy(g), tstate,
            None if cands is None else torch.from_numpy(cands),
            None if a is None else torch.from_numpy(a))
        np.testing.assert_allclose(_np(tpsi), jpsi, rtol=CTC_RTOL, atol=1e-12)
        _state_close(tstate_new, jstate)
        # pick, per sentence, two flat (beam·vocab) candidates not blank
        flat = np.stack([rng.choice([i for i in range(12) if i % 6 != BLANK],
                                    2, replace=False) for _ in range(2)])
        jstate = js.permute_mem(jstate, flat)
        tstate = ts.permute_mem(tstate_new, torch.from_numpy(flat))
        _state_close(tstate, jstate)
        rows = (flat // 6 + np.array([[0], [2]])).reshape(-1)
        g = np.concatenate([g[rows], (flat % 6).reshape(-1, 1)], axis=1)


# ------------------------------------------------------------ searchers

class _Tables:
    """Per step, sentence and previous token: the next token's log-probs
    (EOS raised so that hypotheses end at several lengths) and an
    attention row."""

    def __init__(self, seed):
        rng = np.random.default_rng(seed)
        logits = rng.standard_normal((T + 2, B, V, V)) * 1.5
        logits[..., EOS] += 1.5
        self.lp = _log_softmax(logits)
        self.attn = rng.random((T + 2, B, V, T)).astype(np.float32) ** 4
        self.attn /= self.attn.sum(-1, keepdims=True)
        self.ctc = _log_softmax(rng.standard_normal((B, T, V)) * 2)
        self.lm = _log_softmax(rng.standard_normal((V, V)))


def _toy(base, to_array):
    """The same toy searcher over either package's base class; ``to_array``
    makes the package's array type."""

    class Toy(base):
        def __init__(self, tables, **kw):
            super().__init__(**kw)
            self.t = tables

        def reset_mem(self, batch_size):
            return {"step": 0}

        def forward_step(self, inp_tokens, memory, enc_states, enc_lens):
            tok, s = _np(inp_tokens), memory["step"]
            sent = _np(enc_states)[:, 0, 0].astype(np.int64)
            return (to_array(self.t.lp[s, sent, tok]), {"step": s + 1},
                    to_array(self.t.attn[s, sent, tok]))

        def ctc_forward_step(self, x):
            return to_array(self.t.ctc)

        def lm_forward_step(self, inp_tokens, memory):
            return to_array(self.t.lm[_np(inp_tokens)]), memory

    return Toy


def _enc():
    """Encoder states whose first entry names the sentence for the toy."""
    enc = np.zeros((B, T, 4), np.float32)
    enc[:, 0, 0] = np.arange(B)
    return enc


JToyBeam = _toy(js2s.S2SBeamSearcher, jnp.asarray)
TToyBeam = _toy(ts2s.S2SBeamSearcher, torch.from_numpy)

BEAM_OPTIONS = {
    "defaults": dict(),
    "no_threshold_rewarding_topk": dict(
        using_eos_threshold=False, length_normalization=False,
        length_rewarding=0.5, return_topk=True, topk=2),
    "min_ratio": dict(min_decode_ratio=0.5, eos_threshold=3.0),
    "ctc_full": dict(ctc_weight=0.4, blank_index=BLANK),
    "ctc_partial_window": dict(ctc_weight=0.4, blank_index=BLANK,
                               ctc_score_mode="partial", ctc_window_size=2),
    "ctc_only": dict(ctc_weight=1.0, blank_index=BLANK),
    "attn_shift_coverage": dict(using_max_attn_shift=True, max_attn_shift=3,
                                coverage_penalty=0.3),
    "lm": dict(lm_weight=0.5, return_topk=True, topk=3),
}


@pytest.mark.parametrize("name", sorted(BEAM_OPTIONS))
def test_beam_searcher_matches_jax(name):
    tables = _Tables(3)
    kw = dict(dict(bos_index=BOS, eos_index=EOS, min_decode_ratio=0.0,
                   max_decode_ratio=1.0, beam_size=BEAM), **BEAM_OPTIONS[name])
    enc = _enc()
    lens = np.array([1.0, 0.6667], np.float32)
    want_h, want_s = JToyBeam(tables, **kw)(jnp.asarray(enc),
                                            jnp.asarray(lens))
    got_h, got_s = TToyBeam(tables, **kw)(torch.from_numpy(enc),
                                          torch.from_numpy(lens))
    assert got_h == want_h
    np.testing.assert_allclose(np.asarray(got_s, np.float64),
                               np.asarray(want_s, np.float64),
                               rtol=1e-6, atol=ATOL)


def test_beam_searcher_refuses_what_jax_refuses():
    for pkg in (js2s, ts2s):
        with pytest.raises(ValueError, match="different indexes"):
            pkg.S2SBeamSearcher(BOS, EOS, 0.0, 1.0, 2, ctc_weight=0.5,
                                blank_index=EOS)
        with pytest.raises(NotImplementedError, match="ctc_forward_step"):
            pkg.S2SBeamSearcher(BOS, EOS, 0.0, 1.0, 2, ctc_weight=0.5,
                                blank_index=BLANK)(np.zeros((1, 2, 3)),
                                                   np.ones(1))


def test_greedy_searcher_matches_jax():
    tables = _Tables(4)
    kw = dict(bos_index=BOS, eos_index=EOS, min_decode_ratio=0.0,
              max_decode_ratio=1.0)
    enc = _enc()
    want = _toy(js2s.S2SGreedySearcher, jnp.asarray)(tables, **kw)(
        jnp.asarray(enc), jnp.ones(B))
    got = _toy(ts2s.S2SGreedySearcher, torch.from_numpy)(tables, **kw)(
        torch.from_numpy(enc), torch.ones(B))
    assert got[0] == want[0]
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=ATOL)


def test_output_filters_and_tensor_helpers_match_jax():
    pred = np.array([[3, 5, 1, 7], [4, 4, 4, 4]])
    assert ts2s.batch_filter_seq2seq_output(torch.from_numpy(pred), EOS) == \
        js2s.batch_filter_seq2seq_output(pred, EOS)
    assert ts2s.filter_seq2seq_output([3, 1, 5], EOS) == [3]
    with pytest.raises(ValueError):
        ts2s.filter_seq2seq_output((3, 1), EOS)
    x = np.arange(6.0, dtype=np.float32).reshape(2, 3)
    for dim in (0, 1):
        np.testing.assert_array_equal(
            ts2s.inflate_tensor(torch.from_numpy(x), 2, dim).numpy(),
            np.asarray(js2s.inflate_tensor(jnp.asarray(x), 2, dim)))
    cond = x > 2
    np.testing.assert_array_equal(
        ts2s.mask_by_condition(torch.from_numpy(x), torch.from_numpy(cond),
                               -1.0).numpy(),
        np.asarray(js2s.mask_by_condition(jnp.asarray(x), cond, -1.0)))
