"""Port parity, the searchers over models: ``S2SRNNGreedySearcher``,
``S2SRNNBeamSearcher`` (GRU with location-aware attention, whose previous
weights ``permute_mem`` reorders; LSTM with content attention, whose (h, c)
pairs it reorders), ``S2SRNNBeamSearchLM`` over an ``RNNLM``,
``S2SRNNBeamSearchTransformerLM`` over a ``TransformerLM`` and
``S2STransformerBeamSearch`` over a ``TransformerASR``, against the JAX
searchers on the same numpy weights and encoder states: hypotheses equal
and scores within 1e-5, beams 1-3, CTC weight 0 and 0.4, LM weight 0 and
0.5, at most 6 steps (the JAX searchers compile a program per prefix
length). Also the transformer searcher's unmasked padded frames and the
searchers' host reads."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from svt_speechbrain_tpu.decoders import seq2seq as jsearch
from svt_speechbrain_tpu.models import rnnlm as jrnnlm
from svt_speechbrain_tpu.models import transformer_asr as jasr
from svt_speechbrain_tpu.nnet import rnn as jrnn
from svt_speechbrain_tpu.nnet.embedding import Embedding as JEmbedding
from svt_speechbrain_tpu.nnet.linear import Linear as JLinear

from svt_speechbrain_tpu_torch.convert_jax import load_module_tree, seeded_tree
from svt_speechbrain_tpu_torch.decoders import seq2seq as tsearch
from svt_speechbrain_tpu_torch.models import rnnlm as trnnlm
from svt_speechbrain_tpu_torch.models import transformer_asr as tasr
from svt_speechbrain_tpu_torch.nnet import rnn as trnn
from svt_speechbrain_tpu_torch.nnet.embedding import Embedding
from svt_speechbrain_tpu_torch.nnet.linear import Linear
from tests.torch_threads import two_torch_threads  # noqa: F401

V, E, ENC, HID, ATT, T, B = 9, 5, 6, 7, 4, 8, 2
STEPS = 6
# f32 on both sides: log-probabilities of order 1, summed over 6 steps
SCORE_ATOL = 1e-5
COMMON = dict(bos_index=1, eos_index=2, min_decode_ratio=0.0,
              max_decode_ratio=STEPS / T)


def _seeded(tmod, seed):
    tree = seeded_tree(tmod, torch.Generator().manual_seed(seed))
    load_module_tree(tmod, tree)
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _enc(seed=0):
    x = np.random.default_rng(seed).normal(size=(B, T, ENC)).astype(
        np.float32)
    return x, np.array([1.0, 0.75], np.float32)


def _same(got, want):
    (g_hyps, g_scores), (w_hyps, w_scores) = got, want
    assert g_hyps == w_hyps
    np.testing.assert_allclose(np.asarray(g_scores, np.float64),
                               np.asarray(w_scores, np.float64),
                               atol=SCORE_ATOL, rtol=0)


def _rnn_pair(rnn_type="gru", attn_type="location", seed=0):
    kw = dict(hidden_size=HID, attn_dim=ATT, num_layers=1, enc_dim=ENC,
              input_size=E)
    if attn_type == "location":
        kw.update(channels=3, kernel_size=2)
    tmods = {"emb": Embedding(V, E),
             "dec": trnn.AttentionalRNNDecoder(rnn_type, attn_type, **kw),
             "fc": Linear(V, HID), "ctc_fc": Linear(V, ENC)}
    params = {k: _seeded(m, seed + i) for i, (k, m) in
              enumerate(tmods.items())}
    jmods = {"emb": JEmbedding(V, E),
             "dec": jrnn.AttentionalRNNDecoder(rnn_type, attn_type, **kw),
             "fc": JLinear(V, HID), "ctc_fc": JLinear(V, ENC)}
    return jmods, tmods, params


def test_rnn_greedy_searcher():
    jmods, tmods, params = _rnn_pair()
    x, lens = _enc()
    want = jsearch.S2SRNNGreedySearcher(
        jmods["emb"], jmods["dec"], jmods["fc"], params, **COMMON)(
        jnp.asarray(x), jnp.asarray(lens))
    got = tsearch.S2SRNNGreedySearcher(
        tmods["emb"], tmods["dec"], tmods["fc"], **COMMON)(
        torch.from_numpy(x), torch.from_numpy(lens))
    _same(got, want)


@pytest.mark.parametrize("rnn_type,attn_type,beam,ctc", [
    ("gru", "location", 1, 0.0), ("gru", "location", 3, 0.4),
    ("lstm", "content", 2, 0.0), ("lstm", "content", 3, 0.4)])
def test_rnn_beam_searcher(rnn_type, attn_type, beam, ctc):
    jmods, tmods, params = _rnn_pair(rnn_type, attn_type)
    x, lens = _enc(1)
    kw = dict(COMMON, beam_size=beam, ctc_weight=ctc, blank_index=0,
              eos_threshold=3.0)
    want = jsearch.S2SRNNBeamSearcher(
        jmods["emb"], jmods["dec"], jmods["fc"], params,
        ctc_linear=jmods["ctc_fc"], temperature=1.3, **kw)(
        jnp.asarray(x), jnp.asarray(lens))
    search = tsearch.S2SRNNBeamSearcher(
        tmods["emb"], tmods["dec"], tmods["fc"], ctc_linear=tmods["ctc_fc"],
        temperature=1.3, **kw)
    got = search(torch.from_numpy(x), torch.from_numpy(lens))
    _same(got, want)
    # a step reads its log-probabilities, and with CTC the scorer's
    assert 1 <= search.host_reads <= (2 if ctc else 1) * STEPS + 1


def _lms(kind, seed=10):
    if kind == "rnnlm":
        kw = dict(output_neurons=V, embedding_dim=4, rnn_layers=2,
                  rnn_neurons=6, dnn_blocks=1, dnn_neurons=5, dropout=0.0)
        jlm, tlm = jrnnlm.RNNLM(**kw), trnnlm.RNNLM(**kw)
    else:
        kw = dict(vocab=V, d_model=8, nhead=2, num_encoder_layers=2,
                  d_ffn=16, dropout=0.0)
        jlm, tlm = jasr.TransformerLM(**kw), tasr.TransformerLM(**kw)
    return jlm, tlm, _seeded(tlm, seed)


@pytest.mark.parametrize("kind,beam,ctc,lm_weight", [
    ("rnnlm", 3, 0.4, 0.5), ("transformer", 3, 0.0, 0.5),
    ("transformer", 2, 0.4, 0.0)])
def test_rnn_beam_search_with_an_lm(kind, beam, ctc, lm_weight):
    jmods, tmods, params = _rnn_pair()
    jlm, tlm, lm_params = _lms(kind)
    x, lens = _enc(2)
    kw = dict(COMMON, beam_size=beam, ctc_weight=ctc, blank_index=0,
              lm_weight=lm_weight, temperature_lm=1.2)
    jcls, tcls = ((jsearch.S2SRNNBeamSearchLM, tsearch.S2SRNNBeamSearchLM)
                  if kind == "rnnlm" else
                  (jsearch.S2SRNNBeamSearchTransformerLM,
                   tsearch.S2SRNNBeamSearchTransformerLM))
    want = jcls(jmods["emb"], jmods["dec"], jmods["fc"], jlm, lm_params,
                params, ctc_linear=jmods["ctc_fc"], **kw)(
        jnp.asarray(x), jnp.asarray(lens))
    got = tcls(tmods["emb"], tmods["dec"], tmods["fc"], tlm,
               ctc_linear=tmods["ctc_fc"], **kw)(
        torch.from_numpy(x), torch.from_numpy(lens))
    _same(got, want)


def _asr_pair(seed=20):
    kw = dict(tgt_vocab=V, input_size=ENC, d_model=8, nhead=2,
              num_encoder_layers=1, num_decoder_layers=2, d_ffn=16,
              dropout=0.0)
    tmods = [tasr.TransformerASR(**kw), Linear(V, 8), Linear(V, 8)]
    params = [_seeded(m, seed + i) for i, m in enumerate(tmods)]
    jmods = [jasr.TransformerASR(**kw), JLinear(V, 8), JLinear(V, 8)]
    return jmods, tmods, params


@pytest.mark.parametrize("beam,ctc", [(1, 0.0), (3, 0.4)])
def test_transformer_beam_search(beam, ctc):
    jmods, tmods, params = _asr_pair()
    src, lens = _enc(3)
    enc = np.asarray(jmods[0].encode(params[0], jnp.asarray(src),
                                     jnp.asarray(lens))[0])
    with torch.no_grad():
        tenc, _ = tmods[0].encode(torch.from_numpy(src),
                                  torch.from_numpy(lens))
    np.testing.assert_allclose(tenc.numpy(), enc, atol=1e-5)
    kw = dict(COMMON, beam_size=beam, ctc_weight=ctc, blank_index=0)
    want = jsearch.S2STransformerBeamSearch(
        jmods, params, temperature=1.1, **kw)(jnp.asarray(enc),
                                              jnp.asarray(lens))
    got = tsearch.S2STransformerBeamSearch(tmods, temperature=1.1, **kw)(
        torch.from_numpy(enc), torch.from_numpy(lens))
    _same(got, want)


def test_transformer_beam_search_attends_padded_frames():
    """The step decodes with no encoder padding mask, as the JAX step: a
    shorter row's padded frames change its scores."""
    _, tmods, _ = _asr_pair()
    with torch.no_grad():
        enc = tmods[0].encode(torch.from_numpy(_enc(4)[0]))[0]
    lens = torch.tensor([1.0, 0.5])
    search = tsearch.S2STransformerBeamSearch(tmods[:2], beam_size=2,
                                              **COMMON)
    other = enc.clone()
    other[1, T // 2:] += 1.0
    memory = search.reset_mem(4)
    tokens = torch.full((4,), 1)
    with torch.no_grad():
        a = search.forward_step(tokens, memory, enc.repeat_interleave(2, 0),
                                lens.repeat_interleave(2))[0]
    with torch.no_grad():
        b = search.forward_step(tokens, memory, other.repeat_interleave(2, 0),
                                lens.repeat_interleave(2))[0]
    assert torch.equal(a[:2], b[:2]) and not torch.allclose(a[2:], b[2:])


def test_searchers_refuse_joint_ctc_without_a_head():
    _, tmods, _ = _rnn_pair()
    with pytest.raises(ValueError):
        tsearch.S2SRNNBeamSearcher(tmods["emb"], tmods["dec"], tmods["fc"],
                                   beam_size=2, ctc_weight=0.5,
                                   blank_index=0, **COMMON)
    _, asr, _ = _asr_pair()
    with pytest.raises(ValueError):
        tsearch.S2STransformerBeamSearch(asr[:2], beam_size=2, ctc_weight=0.5,
                                         blank_index=0, **COMMON)
