"""Port parity, ``alignment/``: ``HMMAligner`` (forward scores under every
``batch_reduction`` and length normalization, Viterbi scores and
alignments, the lexicon graph and its Viterbi, flat start and stored
alignments, state expansion, accuracy, collapse, save and load in either
package's format), ``batch_log_matvecmul``/``batch_log_maxvecmul``, the
``ctc_segmentation`` dynamic programme on seeded posteriors and
``CTCSegmentation`` over a TINY ``EncoderASR``, each against the JAX
package on the same seeded numpy inputs, on the CPU.

Tolerances: the aligner's DPs run in f64 in both packages (numpy in the
JAX one, torch here): scores within 1e-10 of their size, alignments equal;
the log-space products in f32 within 1e-6; the segmentation's DP is the
JAX package's numpy code, copied: equal on equal posteriors, and over the
TINY encoder, whose f32 posteriors agree within 1e-5, equal boundaries."""
import pickle
import random

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from svt_speechbrain_tpu.alignment import aligner as jal
from svt_speechbrain_tpu.alignment import ctc_segmentation as jseg

from svt_speechbrain_tpu_torch.alignment import aligner as tal
from svt_speechbrain_tpu_torch.alignment import ctc_segmentation as tseg
from svt_speechbrain_tpu_torch.utils.checkpoints import Checkpointer
from tests.test_torch_interfaces_asr_vad import encoder_asr_pair
from tests.torch_threads import two_torch_threads  # noqa: F401

RTOL = 1e-10


def _batch(seed=0, b=3, t=12, v=7, u=4):
    rng = np.random.default_rng(seed)
    emission = np.log(rng.dirichlet(np.ones(v), size=(b, t)))
    lens = np.array([1.0, 0.75, 0.5])[:b]
    phns = rng.integers(0, v, size=(b, u))
    phn_lens = np.array([1.0, 0.75, 0.5])[:b]
    return emission, lens, phns, phn_lens


def _t(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


@pytest.mark.parametrize("reduction,in_norm,tg_norm", [
    ("none", False, False), ("mean", True, False), ("sum", False, True),
    ("none", True, True)])
def test_forward_scores(reduction, in_norm, tg_norm):
    emission, lens, phns, phn_lens = _batch()
    kw = dict(batch_reduction=reduction, input_len_norm=in_norm,
              target_len_norm=tg_norm)
    got = tal.HMMAligner(**kw).forward(*_t(emission, lens, phns, phn_lens),
                                       dp_algorithm="forward")
    want = jal.HMMAligner(**kw).forward(emission, lens, phns, phn_lens,
                                        dp_algorithm="forward")
    assert got.dtype == torch.float64
    np.testing.assert_allclose(np.atleast_1d(got.numpy()),
                               np.atleast_1d(want), rtol=RTOL)


@pytest.mark.parametrize("seed,f32", [(1, False), (4, True)])
def test_viterbi_scores_and_alignments(seed, f32):
    emission, lens, phns, phn_lens = _batch(seed=seed, t=15)
    if f32:        # f32 emissions are taken to f64 by both packages
        emission = emission.astype(np.float32)
    got, galign = tal.HMMAligner().forward(
        *_t(emission, lens, phns, phn_lens), dp_algorithm="viterbi")
    want, walign = jal.HMMAligner().forward(emission, lens, phns, phn_lens,
                                            dp_algorithm="viterbi")
    assert galign == walign
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL)
    locs, score = tal.HMMAligner().align(emission[0], list(phns[0]))
    jlocs, jscore = jal.HMMAligner().align(emission[0], list(phns[0]))
    np.testing.assert_array_equal(locs, jlocs)
    assert abs(score - jscore) <= RTOL * abs(jscore)


LEXICON = """\
;;; comment header line one
;;; comment header line two
read /r eh1 d/
read~1 /r iy2 d/
a /ah0/
moon /m uw1 n/
"""


@pytest.mark.parametrize("interword_sils,spp", [(True, 1), (False, 2)])
def test_lexicon_graph_and_viterbi(tmp_path, interword_sils, spp):
    path = tmp_path / "lexicon.txt"
    path.write_text(LEXICON)
    ours = tal.HMMAligner(lexicon_path=str(path), states_per_phoneme=spp)
    theirs = jal.HMMAligner(lexicon_path=str(path), states_per_phoneme=spp)
    assert ours.lexicon == theirs.lexicon
    assert ours.lex_lab2ind == theirs.lex_lab2ind
    assert ours.lex_ind2lab == theirs.lex_ind2lab
    words = [["read", "a", "moon"], ["a", "read"]]
    got = ours.use_lexicon(words, interword_sils=interword_sils)
    want = theirs.use_lexicon(words, interword_sils=interword_sils)
    for g, w in zip(got[:4], want[:4]):
        np.testing.assert_array_equal(g.numpy(), w)
    assert got[4] == want[4]
    n_states = 2 * spp * (len(ours.lex_lab2ind))
    rng = np.random.default_rng(3)
    emission = np.log(rng.dirichlet(np.ones(n_states), size=(2, 30)))
    lens = np.array([1.0, 0.8])
    matrices = [dict(pi_prob=m[3], trans_prob=m[2], final_states=m[4])
                for m in (got, want)]
    gscore, galign = ours.forward(
        *_t(emission, lens), got[0], got[1], dp_algorithm="viterbi",
        prob_matrices=matrices[0])
    wscore, walign = theirs.forward(
        emission, lens, want[0], want[1], dp_algorithm="viterbi",
        prob_matrices=matrices[1])
    assert galign == walign
    np.testing.assert_allclose(gscore.numpy(), wscore, rtol=RTOL)
    fwd = ours.forward(*_t(emission, lens), got[0], got[1],
                       dp_algorithm="forward", prob_matrices=matrices[0])
    np.testing.assert_allclose(
        fwd.numpy(), theirs.forward(emission, lens, want[0], want[1],
                                    dp_algorithm="forward",
                                    prob_matrices=matrices[1]), rtol=RTOL)


def test_sampled_pronunciations_follow_pythons_random(tmp_path):
    path = tmp_path / "lexicon.txt"
    path.write_text(LEXICON)
    words = [["read", "read", "moon", "read"]] * 3
    out = []
    for mod in (tal, jal):
        random.seed(11)
        aligner = mod.HMMAligner(lexicon_path=str(path))
        out.append(aligner.use_lexicon(words, sample_pron=True))
    np.testing.assert_array_equal(out[0][0].numpy(), out[1][0])
    np.testing.assert_array_equal(out[0][2].numpy(), out[1][2])


def test_flat_start_stored_alignments_and_persistence(tmp_path):
    emission, lens, phns, phn_lens = _batch(seed=2)
    ours, theirs = tal.HMMAligner(), jal.HMMAligner()
    ids = [f"utt{i}" for i in range(len(lens))]
    flat = ours.get_prev_alignments(ids, *_t(emission, lens, phns,
                                             phn_lens))
    np.testing.assert_array_equal(flat.numpy(), theirs.get_prev_alignments(
        ids, emission, lens, phns, phn_lens))
    aligns = [[1, 1, 2], [3, 4, 4, 4], [2]]
    ours.store_alignments(ids, [torch.tensor(a) for a in aligns])
    theirs.store_alignments(ids, aligns)
    np.testing.assert_array_equal(
        ours.get_prev_alignments(ids, *_t(emission, lens, phns,
                                          phn_lens)).numpy(),
        theirs.get_prev_alignments(ids, emission, lens, phns, phn_lens))
    # the JAX aligner's save loads in the port, and the port's in the JAX
    theirs._save(tmp_path / "jax.pkl")
    ours._save(tmp_path / "port.pkl")
    assert (tmp_path / "jax.pkl").read_bytes() == (
        tmp_path / "port.pkl").read_bytes()
    fresh = tal.HMMAligner()
    fresh._load(tmp_path / "jax.pkl")
    jfresh = jal.HMMAligner()
    jfresh._load(tmp_path / "port.pkl")
    for key in ids:
        np.testing.assert_array_equal(fresh.align_dict[key],
                                      jfresh.align_dict[key])
        assert fresh.align_dict[key].dtype == np.int16
    # and through the Checkpointer's hooks
    ckpt = Checkpointer(str(tmp_path / "ckpt"), {"aligner": ours})
    ckpt.save_checkpoint(verbosity=0)
    restored = tal.HMMAligner()
    Checkpointer(str(tmp_path / "ckpt"),
                 {"aligner": restored}).recover_if_possible()
    assert pickle.dumps(restored.align_dict) == pickle.dumps(
        {k: np.asarray(v) for k, v in ours.align_dict.items()})


def test_expand_accuracy_collapse():
    ours, theirs = (mod.HMMAligner(states_per_phoneme=3)
                    for mod in (tal, jal))
    phns = np.array([[0., 3., 5., 0.], [0., 2., 0., 0.]])
    phn_lens = np.array([1., 0.75])
    np.testing.assert_array_equal(
        ours.expand_phns_by_states_per_phoneme(*_t(phns, phn_lens)).numpy(),
        theirs.expand_phns_by_states_per_phoneme(phns, phn_lens))
    align = [0, 1, 2, 3, 4, 5, 3, 4, 5, 0, 1, 2]
    assert ours.collapse_alignments(align) == theirs.collapse_alignments(
        align)
    args = ([[0, 0, 1, 1, 2, 2, 2, 0]], [[4, 10, 16]], [[0, 1, 2]])
    np.testing.assert_array_equal(ours.calc_accuracy(*args).numpy(),
                                  theirs.calc_accuracy(*args))
    one, jone = tal.HMMAligner(), jal.HMMAligner()
    args = ([[0., 0., 0., 1.]], [[2, 4]], [[0., 1.]])
    np.testing.assert_array_equal(one.calc_accuracy(*args).numpy(),
                                  jone.calc_accuracy(*args))
    # with label maps: both sides mapped onto their labels' shared indices
    # (the JAX aligner raises here, ROADMAP.md queue 3)
    ind2labs = ({0: "a", 1: "b"}, {5: "a", 7: "b"})
    got = one.calc_accuracy([[0, 0, 1, 1]], [[2, 4]], [[5, 7]], ind2labs)
    assert float(got[0]) == 100.0
    with pytest.raises(ValueError):
        jone.calc_accuracy([[0, 0, 1, 1]], [[2, 4]], [[5, 7]], ind2labs)
    assert tal.map_inds_to_intersect([[0, 1]], [[7]], ind2labs) == \
        jal.map_inds_to_intersect([[0, 1]], [[7]], ind2labs)


def test_batch_log_products():
    rng = np.random.default_rng(5)
    a = np.log(rng.dirichlet(np.ones(6), size=(3, 6))).astype(np.float32)
    b = np.log(rng.dirichlet(np.ones(6), size=3)).astype(np.float32)
    np.testing.assert_allclose(
        tal.batch_log_matvecmul(*_t(a, b)).numpy(),
        np.asarray(jal.batch_log_matvecmul(jnp.asarray(a), jnp.asarray(b))),
        atol=1e-6)
    v, idx = tal.batch_log_maxvecmul(*_t(a, b))
    jv, jidx = jal.batch_log_maxvecmul(jnp.asarray(a), jnp.asarray(b))
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), atol=1e-6)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    tie = torch.zeros(1, 2, 3)                    # ties: the lower index
    assert tal.batch_log_maxvecmul(tie, torch.zeros(1, 3))[1].tolist() == [
        [0, 0]]


def test_ctc_segmentation_dp():
    rng = np.random.default_rng(6)
    lp = rng.normal(size=(60, 9))
    lp -= np.log(np.exp(lp).sum(1, keepdims=True))
    tokens = [[1, 2, 2], [5], [3, 7, 8, 1]]
    for kw in (dict(), dict(blank_id=4, frame_duration=0.04)):
        assert tseg.ctc_segmentation(lp, tokens, **kw) == \
            jseg.ctc_segmentation(lp, tokens, **kw)
    task = tseg.CTCSegmentationTask([(0.0, 0.5, -1.25)], ["hi"], name="r")
    assert str(task) == str(jseg.CTCSegmentationTask([(0.0, 0.5, -1.25)],
                                                     ["hi"], name="r"))


def test_ctc_segmentation_over_a_tiny_encoder_asr(tmp_path):
    tface, jface = encoder_asr_pair(tmp_path, seed=4)
    wav = 0.1 * np.random.default_rng(7).standard_normal(
        (1, 12800)).astype(np.float32)
    texts = "the cat sat\nan owl\nblue moon rises"
    got = tseg.CTCSegmentation(tface)
    want = jseg.CTCSegmentation(jface)
    lpz = got.get_lpz(wav)
    assert lpz.dtype == np.float64 and lpz.shape == (39, 80)
    np.testing.assert_allclose(lpz, want.get_lpz(wav), atol=1e-5)
    task = got(wav, texts, name="rec")
    assert len(task.segments) == 3
    # the DP on the JAX posteriors, and on the port's own, in both
    # packages: the same boundaries (the posteriors part in the 7th
    # digit, far from any decision of the path)
    jtask = want(wav, texts, name="rec")
    assert [s[:2] for s in task.segments] == [s[:2] for s in jtask.segments]
    assert str(tseg.CTCSegmentationTask(task.segments, jtask.text,
                                        "rec")) == str(task)
    kaldi = tseg.CTCSegmentation(tface, kaldi_style_text=True)
    assert kaldi(wav, ["u1 the cat sat", "u2 an owl"]).text == [
        "the cat sat", "an owl"]
