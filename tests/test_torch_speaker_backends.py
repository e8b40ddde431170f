"""Port parity, the speaker and separation back-ends: ``processing/
plda_lda.py`` (the PLDA EM trajectory, ``fast_PLDA_scoring`` with and
without open-set priors, LDA), ``processing/diarization.py`` (spectral
clustering labels and the RTTM bytes, with sklearn present and with its
import blocked in both packages, where k-means falls back to the
package's own ``_kmeans``) and ``processing/nmf.py`` (``NMF_separate_spectra``,
``reconstruct_results``, the factorization helpers), each against the JAX
package on the same seeded numpy inputs on the CPU.

The plda, diarization and factorization code is the JAX package's numpy
and scipy code, copied: held bit for bit. ``reconstruct_results`` runs the
port's ``spectral_magnitude`` and ``ISTFT`` (torch) where the JAX one runs
its own (jax), f32: waveforms scaled to std 0.1 within 1e-6."""
import copy
import sys

import numpy as np
import pytest

from svt_speechbrain_tpu.processing import diarization as jdia
from svt_speechbrain_tpu.processing import nmf as jnmf
from svt_speechbrain_tpu.processing import plda_lda as jplda

from svt_speechbrain_tpu_torch.processing import diarization as tdia
from svt_speechbrain_tpu_torch.processing import nmf as tnmf
from svt_speechbrain_tpu_torch.processing import plda_lda as tplda


def _dataset(seed=0, dim=8, rank=3, n_spk=6, per_spk=7):
    rng = np.random.default_rng(seed)
    F = rng.normal(size=(dim, rank))
    means = rng.normal(size=(n_spk, rank)) @ F.T
    x = np.concatenate([means[s] + 0.4 * rng.normal(size=(per_spk, dim))
                        for s in range(n_spk)])
    labels = np.array([f"s{s}" for s in range(n_spk) for _ in range(per_spk)],
                      dtype="|O")
    segs = np.array([f"u{i}" for i in range(len(x))], dtype="|O")
    return x, labels, segs, means


def _stats(mod, x, models, segs):
    return mod.StatObject_SB(modelset=models.copy(), segset=segs.copy(),
                             stat0=np.ones((len(x), 1)), stat1=x.copy())


@pytest.mark.parametrize("nb_iter,scaling", [(2, 1.0), (3, 0.5)])
def test_plda_em_trajectory(nb_iter, scaling):
    x, labels, segs, _ = _dataset()
    got, want = (mod.PLDA(rank_f=3, nb_iter=nb_iter, scaling_factor=scaling)
                 for mod in (tplda, jplda))
    got.plda(_stats(tplda, x, labels, segs))
    want.plda(_stats(jplda, x, labels, segs))
    for name in ("mean", "F", "Sigma"):
        np.testing.assert_array_equal(getattr(got, name),
                                      getattr(want, name))


@pytest.mark.parametrize("p_known", [0.0, 0.5])
def test_fast_plda_scoring(p_known):
    x, labels, segs, means = _dataset(seed=1)
    plda = jplda.PLDA(rank_f=3, nb_iter=2)
    plda.plda(_stats(jplda, x, labels, segs))
    rng = np.random.default_rng(9)
    en_x = means[:4] + 0.1 * rng.normal(size=(4, means.shape[1]))
    te_x = means[:5] + 0.1 * rng.normal(size=(5, means.shape[1]))
    en_models = np.array(["e0", "e0", "e1", "e2"], dtype="|O")
    en_segs = np.array([f"es{i}" for i in range(4)], dtype="|O")
    te_segs = np.array([f"t{i}" for i in range(5)], dtype="|O")
    out = []
    for mod in (tplda, jplda):
        ndx = mod.Ndx(models=np.array(["e0", "e1", "e2"], dtype="|O"),
                      testsegs=te_segs)
        out.append(mod.fast_PLDA_scoring(
            _stats(mod, en_x, en_models, en_segs),
            _stats(mod, te_x, te_segs, te_segs), ndx, plda.mean, plda.F,
            plda.Sigma, p_known=p_known))
    got, want = out
    assert list(got.modelset) == list(want.modelset)
    assert list(got.segset) == list(want.segset)
    np.testing.assert_array_equal(got.scoremask, want.scoremask)
    np.testing.assert_array_equal(got.scoremat, want.scoremat)


def test_lda():
    x, labels, segs, _ = _dataset(seed=2)
    got = tplda.LDA(reduce_dim=2).do_lda(_stats(tplda, x, labels, segs))
    want = jplda.LDA(reduce_dim=2).do_lda(_stats(jplda, x, labels, segs))
    np.testing.assert_array_equal(got.stat1, want.stat1)


def _embeddings(seed=0, n_spk=3, per=8, dim=12, spread=0.3):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(n_spk, dim)) * 3
    return np.concatenate([centers[s] + spread * rng.normal(size=(per, dim))
                           for s in range(n_spk)])


class _Diary:
    def __init__(self, emb, segs):
        self.stat1, self.segset = emb.copy(), segs.copy()

    def norm_stat1(self):
        self.stat1 = self.stat1 / np.linalg.norm(self.stat1, axis=1,
                                                 keepdims=True)


@pytest.fixture(params=["sklearn", "blocked"])
def sklearn_or_not(request, monkeypatch):
    """Each case with sklearn importable, and with its import blocked in
    both packages (k-means then runs the package's ``_kmeans``)."""
    if request.param == "blocked":
        for name in [m for m in sys.modules if m.startswith("sklearn")]:
            monkeypatch.delitem(sys.modules, name)
        monkeypatch.setitem(sys.modules, "sklearn", None)
        monkeypatch.setitem(sys.modules, "sklearn.cluster", None)
    else:
        pytest.importorskip("sklearn")
    return request.param


def test_spectral_clustering_and_rttm(tmp_path, sklearn_or_not):
    emb = _embeddings(seed=3, n_spk=3, per=10, spread=0.2)
    segs = np.array([f"rec1_{i * 1.5:.2f}_{i * 1.5 + 2.0:.2f}"
                     for i in range(len(emb))], dtype="|O")
    out = {}
    for name, mod in (("port", tdia), ("jax", jdia)):
        np.random.seed(7)          # sklearn's k_means draws from it
        clust = mod.Spec_Clust_unorm(min_num_spkrs=2, max_num_spkrs=10)
        clust.do_spec_clust(emb, k_oracle=None, p_val=0.3)
        np.random.seed(7)
        labels = mod.do_spec_clustering(
            _Diary(emb, segs), str(tmp_path / f"{name}.rttm"), "rec1",
            k=None, pval=0.3, affinity_type="cos")
        np.random.seed(7)
        km = mod.do_kmeans_clustering(
            _Diary(emb, segs), str(tmp_path / f"{name}_km.rttm"), "rec1",
            k_oracle=None)
        out[name] = (clust.labels_, labels, km)
    for got, want in zip(out["port"], out["jax"]):
        np.testing.assert_array_equal(got, want)
    assert len(set(out["port"][0].tolist())) == 3
    for suffix in (".rttm", "_km.rttm"):
        got = (tmp_path / f"port{suffix}").read_bytes()
        assert got == (tmp_path / f"jax{suffix}").read_bytes() and got
    rttm = tdia.read_rttm(str(tmp_path / "port.rttm"))
    assert rttm == jdia.read_rttm(str(tmp_path / "jax.rttm"))


def test_spectral_embedding_and_segment_chain(tmp_path):
    emb = _embeddings(seed=2, n_spk=2, per=10)
    aff = np.abs(jdia.Spec_Clust_unorm().get_sim_mat(emb))
    # ARPACK's shift-invert eigsh starts from a random vector of its own at
    # every call, so two calls of one function agree to rounding only
    np.testing.assert_allclose(
        tdia.spectral_embedding_sb(aff.copy(), n_components=3),
        jdia.spectral_embedding_sb(aff.copy(), n_components=3),
        rtol=1e-8, atol=1e-10)
    lol = [["r1", 5.5, 7.0, "s1"], ["r1", 6.5, 9.0, "s1"],
           ["r1", 8.0, 11.0, "s2"], ["r1", 11.5, 13.0, "s2"],
           ["r1", 12.0, 15.0, "s1"], ["r1", 14.5, 15.0, "s1"]]
    for fn in ("merge_ssegs_same_speaker", "distribute_overlap"):
        assert (getattr(tdia, fn)(copy.deepcopy(lol))
                == getattr(jdia, fn)(copy.deepcopy(lol)))
    tdia.write_rttm(copy.deepcopy(lol), str(tmp_path / "port.rttm"))
    jdia.write_rttm(copy.deepcopy(lol), str(tmp_path / "jax.rttm"))
    assert ((tmp_path / "port.rttm").read_bytes()
            == (tmp_path / "jax.rttm").read_bytes())


def _nmf_inputs(bs=2, f=11, t=20, k1=4, k2=3, seed=0):
    rng = np.random.default_rng(seed)
    w1 = rng.random((f, k1)).astype(np.float32)
    w2 = rng.random((f, k2)).astype(np.float32)
    xmix = rng.random((bs, t, f)).astype(np.float32) + 0.1
    h0 = (0.1 * rng.random((k1 + k2, bs * t))).astype(np.float32)
    return w1, w2, xmix, h0


def test_nmf_separate_spectra_and_helpers():
    w1, w2, xmix, h0 = _nmf_inputs()
    for args, kw in ((((w1, w2), xmix), dict(h_init=h0, n_iter=50)),
                     (((w1, w2), xmix), dict(seed=3, n_iter=20)),
                     (((w1, w2), xmix[0]), dict(h_init=h0[:, :20]))):
        for got, want in zip(tnmf.NMF_separate_spectra(*args, **kw),
                             jnmf.NMF_separate_spectra(*args, **kw)):
            np.testing.assert_array_equal(got, want)
    v = np.random.default_rng(1).random((6, 9))
    for got, want in zip(tnmf.nmf_factorize(v, rank=2, n_iter=30),
                         jnmf.nmf_factorize(v, rank=2, n_iter=30)):
        np.testing.assert_array_equal(got, want)
    for got, want in zip(tnmf.separate_sources(v, w1[:6], w2[:6], n_iter=30),
                         jnmf.separate_sources(v, w1[:6], w2[:6],
                                               n_iter=30)):
        np.testing.assert_array_equal(got, want)
    stft = np.random.default_rng(2).normal(size=(2, 5, 3, 2))
    np.testing.assert_array_equal(tnmf.spectral_phase(stft),
                                  jnmf.spectral_phase(stft))


def test_nmf_reconstruct_results():
    rng = np.random.default_rng(1)
    bs, f, t = 2, 201, 30          # f of a 25 ms / 16 kHz STFT (n_fft 400)
    x1 = rng.random((bs, f, t)).astype(np.float32)
    x2 = rng.random((bs, f, t)).astype(np.float32)
    x_stft = rng.normal(size=(bs, f, t, 2)).astype(np.float32)
    got = tnmf.reconstruct_results(x1, x2, x_stft, 16000, 25, 10)
    want = jnmf.reconstruct_results(x1, x2, x_stft, 16000, 25, 10)
    for got_k, want_k in zip(got, want):
        assert len(got_k) == len(want_k) == bs
        for g, w in zip(got_k, want_k):
            assert g.shape == w.shape
            np.testing.assert_allclose(g, w, atol=1e-6)
