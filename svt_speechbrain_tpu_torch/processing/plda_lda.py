"""PLDA / LDA speaker modelling (analogue of reference
``speechbrain/processing/PLDA_LDA.py``).

Host-side numpy statistics modelling (these run on embedding sets after
device inference): statistics-object accumulation, LDA projection, EM-trained
PLDA with log-likelihood-ratio scoring.

The PLDA estimator is numerically REFERENCE-EXACT (same init — top
eigenvectors of the observed covariance, unscaled — the same
whiten-per-iteration EM with the minimum-divergence Cholesky step,
``PLDA_LDA.py:892-1004``, and the same Phi/Psi fast scoring,
``PLDA_LDA.py:650-778``), verified by ``tests/test_plda_golden.py`` against
the reference module run on identical data. The E-step is vectorized per
session count instead of the reference's python loop; scipy.linalg routines
match the reference's (note ``scipy.linalg.cholesky`` is UPPER-triangular —
the minimum-divergence step depends on it).

The port's copy of ``svt_speechbrain_tpu/processing/plda_lda.py`` (pure Python, numpy and scipy), kept
identical.
"""
from __future__ import annotations

import copy

import numpy as np
from scipy import linalg


def _sqrt_inv_eigh(sigma):
    """Inverse square root of a covariance via its eigendecomposition with
    eigenvalues sorted DESCENDING (reference ``whiten_stat1``/EM convention —
    the ordering fixes the rotation's sign/column layout, which the EM
    trajectory depends on)."""
    eigen_values, eigen_vectors = linalg.eigh(sigma)
    ind = eigen_values.real.argsort()[::-1]
    eigen_values = eigen_values.real[ind]
    eigen_vectors = eigen_vectors.real[:, ind]
    return eigen_vectors @ np.diag(1.0 / np.sqrt(eigen_values))


class StatObject_SB:
    """Container for (modelset, segset, start, stop, stat0, stat1)
    (reference ``PLDA_LDA.py:32``)."""

    def __init__(self, modelset=None, segset=None, start=None, stop=None,
                 stat0=None, stat1=None):
        self.modelset = np.asarray(modelset) if modelset is not None else np.array([])
        self.segset = np.asarray(segset) if segset is not None else np.array([])
        self.start = start
        self.stop = stop
        self.stat1 = np.asarray(stat1, dtype=np.float64) if stat1 is not None else None
        if stat0 is None and self.stat1 is not None:
            # x-vector convention: one observation per segment
            stat0 = np.ones((self.stat1.shape[0], 1))
        self.stat0 = np.asarray(stat0, dtype=np.float64) if stat0 is not None else None

    def get_mean_stat1(self):
        return np.mean(self.stat1, axis=0)

    def get_total_covariance_stat1(self):
        c = self.stat1 - self.stat1.mean(axis=0)
        return c.T @ c / self.stat1.shape[0]

    def get_model_stat0(self, mod_id):
        return self.stat0[self.modelset == mod_id]

    def get_model_stat1(self, mod_id):
        return self.stat1[self.modelset == mod_id]

    def norm_stat1(self):
        """Divide every stat1 row by its Euclidean norm (reference ``:214``)."""
        vect_norm = np.clip(np.linalg.norm(self.stat1, axis=1), 1e-08, np.inf)
        self.stat1 = (self.stat1.T / vect_norm).T

    def center_stat1(self, mu):
        """Subtract ``stat0 · mu`` from every stat1 row (reference ``:199``):
        zero-order-weighted centering, so SUMMED per-model stats are centered
        by count·mean — the sufficient-statistics convention."""
        mu = np.asarray(mu, dtype=np.float64)
        dim = self.stat1.shape[1] // self.stat0.shape[1]
        index_map = np.repeat(np.arange(self.stat0.shape[1]), dim)
        self.stat1 = self.stat1 - self.stat0[:, index_map] * mu

    def rotate_stat1(self, R):
        """Right-multiply stat1 by ``R`` (reference ``:227``)."""
        self.stat1 = self.stat1 @ R

    def whiten_stat1(self, mu, sigma):
        """Center then rotate by sigma^(-1/2) (full-covariance branch of
        reference ``:233``)."""
        self.center_stat1(mu)
        self.rotate_stat1(_sqrt_inv_eigh(np.asarray(sigma)))

    def sum_stat_per_model(self):
        """Per-model summed stats + session counts (reference ``:224``)."""
        models = np.unique(self.modelset)
        out = StatObject_SB(
            modelset=models, segset=models,
            stat0=np.stack([self.get_model_stat0(m).sum(axis=0) for m in models]),
            stat1=np.stack([self.get_model_stat1(m).sum(axis=0) for m in models]))
        counts = np.array([(self.modelset == m).sum() for m in models],
                          dtype=np.float64)
        return out, counts

    def mean_stat_per_model(self):
        """Per-model averaged stats (reference ``:252``)."""
        summed, counts = self.sum_stat_per_model()
        summed.stat1 = summed.stat1 / counts[:, None]
        summed.stat0 = np.ones((len(counts), self.stat0.shape[1]
                                if self.stat0 is not None else 1))
        return summed

    def align_models(self, model_list):
        """Reorder/trim rows to match ``model_list`` (reference ``:300``)."""
        indx = np.array([np.flatnonzero(self.modelset == v)[0]
                         for v in model_list])
        self.modelset = self.modelset[indx]
        self.segset = self.segset[indx]
        self.stat0 = self.stat0[indx] if self.stat0 is not None else None
        self.stat1 = self.stat1[indx]

    def align_segments(self, segment_list):
        """Reorder/trim rows to match ``segment_list`` (reference ``:322``)."""
        indx = np.array([np.flatnonzero(self.segset == v)[0]
                         for v in segment_list])
        self.modelset = self.modelset[indx]
        self.segset = self.segset[indx]
        self.stat0 = self.stat0[indx] if self.stat0 is not None else None
        self.stat1 = self.stat1[indx]


class LDA:
    """Linear discriminant analysis projection (reference ``PLDA_LDA.py``
    ``do_lda``).

    Example
    -------
    >>> import numpy as np
    >>> rng = np.random.default_rng(0)
    >>> x = np.vstack([rng.normal(size=(20, 4)) * 0.1 + [3, 0, 0, 0],
    ...                rng.normal(size=(20, 4)) * 0.1 + [-3, 0, 0, 0]])
    >>> ids = np.array(["spkA"] * 20 + ["spkB"] * 20)
    >>> st = StatObject_SB(modelset=ids, segset=ids,
    ...                    stat0=np.ones((40, 1)), stat1=x)
    >>> proj = LDA(reduce_dim=1).do_lda(st)
    >>> proj.stat1.shape
    (40, 1)
    >>> bool(abs(proj.stat1[:20].mean() - proj.stat1[20:].mean()) > 4)
    True
    """

    def __init__(self, reduce_dim=2):
        self.reduce_dim = reduce_dim
        self.transform_mat = None

    def do_lda(self, stat_server):
        x = stat_server.stat1
        labels = stat_server.modelset
        classes = np.unique(labels)
        mean = x.mean(axis=0)
        sw = np.zeros((x.shape[1], x.shape[1]))
        sb = np.zeros_like(sw)
        for c in classes:
            xc = x[labels == c]
            mc = xc.mean(axis=0)
            sw += (xc - mc).T @ (xc - mc)
            sb += len(xc) * np.outer(mc - mean, mc - mean)
        evals, evecs = np.linalg.eig(np.linalg.pinv(sw) @ sb)
        order = np.argsort(-evals.real)
        self.transform_mat = evecs[:, order[: self.reduce_dim]].real
        out = StatObject_SB(modelset=stat_server.modelset, segset=stat_server.segset,
                            stat0=stat_server.stat0,
                            stat1=x @ self.transform_mat)
        return out


class PLDA:
    """Probabilistic LDA: simplified eigenvoice model (no within-class
    factor, full residual covariance) trained by the reference's exact EM
    (``PLDA_LDA.py:892-1004``): init F = top eigenvectors of the observed
    covariance; each iteration whitens the summed per-model stats and F by
    the current Sigma, takes the latent posteriors, solves the M-step, and
    applies the minimum-divergence rotation ``F @ cholesky(R)``.

    Example
    -------
    >>> import numpy as np
    >>> rng = np.random.default_rng(0)
    >>> x = np.vstack([rng.normal(size=(20, 4)) * 0.1 + [3, 0, 0, 0],
    ...                rng.normal(size=(20, 4)) * 0.1 + [-3, 0, 0, 0]])
    >>> ids = np.array(["spkA"] * 20 + ["spkB"] * 20)
    >>> st = StatObject_SB(modelset=ids, segset=ids,
    ...                    stat0=np.ones((40, 1)), stat1=x)
    >>> p = PLDA(rank_f=2, nb_iter=5)
    >>> _ = p.plda(st)
    >>> llr = _plda_llr_matrix(p, x[:1], x[[1, 21]])  # enroll A vs (A, B)
    >>> bool(llr[0, 0] > llr[0, 1])   # same-speaker scores higher
    True
    """

    def __init__(self, mean=None, F=None, Sigma=None, rank_f=100, nb_iter=10,
                 scaling_factor=1.0):
        self.mean = mean
        self.F = F
        self.Sigma = Sigma
        self.rank_f = rank_f
        self.nb_iter = nb_iter
        self.scaling_factor = scaling_factor

    def plda(self, stat_server, output_file_name=None, whiten=False,
             w_stat_server=None):
        """EM training of the eigenvoice PLDA model (reference ``plda``,
        ``PLDA_LDA.py:892``) — bit-matching trajectory."""
        del output_file_name
        if whiten:
            stat_server = copy.deepcopy(stat_server)
            stat_server.whiten_stat1(w_stat_server.get_mean_stat1(),
                                     w_stat_server.get_total_covariance_stat1())

        vect_size = stat_server.stat1.shape[1]
        self.mean = stat_server.get_mean_stat1()
        self.Sigma = stat_server.get_total_covariance_stat1()

        model_stat, session_per_model = stat_server.sum_stat_per_model()
        class_nb = model_stat.modelset.shape[0]
        model_stat.stat0 = model_stat.stat0 * self.scaling_factor
        model_stat.stat1 = model_stat.stat1 * self.scaling_factor
        session_per_model = session_per_model * self.scaling_factor

        # init F: top-rank eigenvectors of the observed covariance, unscaled
        sigma_obs = stat_server.get_total_covariance_stat1()
        evals, evecs = linalg.eigh(sigma_obs)
        idx = np.argsort(evals)[::-1]
        self.F = evecs.real[:, idx[: self.rank_f]]
        rank = self.F.shape[1]

        for _ in range(self.nb_iter):
            # whiten the summed stats and F with the CURRENT Sigma; the
            # summed stats are centered by count·mean (center_stat1's
            # zero-order weighting)
            sqr_inv_sigma = _sqrt_inv_eigh(self.Sigma)
            counts = model_stat.stat0[:, 0]
            stat1_w = ((model_stat.stat1 - counts[:, None] * self.mean)
                       @ sqr_inv_sigma)
            f_w = sqr_inv_sigma.T @ self.F

            # E-step, vectorized over models (grouped by session count in
            # place of the reference's per-unique-count inv_lambda cache)
            a = f_w.T @ f_w
            inv_lambda = np.stack([
                linalg.inv(c * a + np.eye(rank)) for c in counts])
            aux = stat1_w @ f_w                              # (C, rank)
            e_h = np.einsum("ci,cij->cj", aux, inv_lambda)   # (C, rank)
            e_hh = inv_lambda + np.einsum("ci,cj->cij", e_h, e_h)

            _R = e_hh.sum(axis=0) / session_per_model.shape[0]
            _C = e_h.T @ stat1_w @ linalg.inv(sqr_inv_sigma)
            _A = np.einsum("cij,c->ij", e_hh, counts)

            # M-step + minimum divergence (scipy cholesky = UPPER triangular)
            self.F = linalg.solve(_A, _C).T
            self.Sigma = sigma_obs - self.F @ _C / session_per_model.sum()
            self.F = self.F @ linalg.cholesky(_R)
        del vect_size, class_nb
        return self

    def scoring(self, enroll, test):
        """LLR score matrix between enroll and test stat1 sets — the
        reference's ``fast_PLDA_scoring`` over the full trial grid."""
        ndx = Ndx(models=enroll.modelset, testsegs=test.segset)
        return fast_PLDA_scoring(enroll, test, ndx, self.mean, self.F,
                                 self.Sigma,
                                 scaling_factor=self.scaling_factor)


class Ndx:
    """Trial index: models × test segments with a validity mask
    (reference ``PLDA_LDA.py:393``). ``modelset``/``segset`` are the unique
    sorted names; ``trialmask[m, s]`` marks trials of interest."""

    def __init__(self, ndx_file_name="", models=np.array([]),
                 testsegs=np.array([])):
        del ndx_file_name
        models = np.asarray(models)
        testsegs = np.asarray(testsegs)
        d = models.shape[0] - testsegs.shape[0]
        if d > 0:
            testsegs = np.hstack((testsegs, [testsegs[-1]] * d))
        elif d < 0:
            models = np.hstack((models, [models[-1]] * (-d)))
        self.modelset = np.unique(models)
        self.segset = np.unique(testsegs)
        self.trialmask = np.zeros((len(self.modelset), len(self.segset)),
                                  dtype=bool)
        for m in range(len(self.modelset)):
            segs = testsegs[np.array(ismember(models, self.modelset[m]))]
            self.trialmask[m] = ismember(self.segset, segs)

    def filter(self, modlist, seglist, keep):
        """Keep (or discard) the given models/segments (reference ``:500``)."""
        if keep:
            keepmods, keepsegs = modlist, seglist
        else:
            keepmods = diff(self.modelset, modlist)
            keepsegs = diff(self.segset, seglist)
        keepmodidx = np.array(ismember(self.modelset, keepmods))
        keepsegidx = np.array(ismember(self.segset, keepsegs))
        out = Ndx()
        out.modelset = self.modelset[keepmodidx]
        out.segset = self.segset[keepsegidx]
        out.trialmask = self.trialmask[keepmodidx][:, keepsegidx]
        return out


def ismember(list1, list2):
    """Elementwise membership mask (reference ``PLDA_LDA.py:31``)."""
    s = set(np.atleast_1d(np.asarray(list2)).tolist())
    return [item in s for item in np.atleast_1d(np.asarray(list1)).tolist()]


def diff(list1, list2):
    """Set difference keeping order (reference ``PLDA_LDA.py:24``)."""
    s = set(np.atleast_1d(np.asarray(list2)).tolist())
    return [item for item in np.atleast_1d(np.asarray(list1)).tolist()
            if item not in s]


class Scores:
    """Score-matrix container (reference ``PLDA_LDA.py:Scores``):
    ``modelset`` × ``segset`` with a validity mask."""

    def __init__(self, scores=None, modelset=None, segset=None, scoremask=None):
        self.scoremat = np.array([]) if scores is None else np.asarray(scores)
        self.modelset = np.array([]) if modelset is None else np.asarray(modelset)
        self.segset = np.array([]) if segset is None else np.asarray(segset)
        self.scoremask = (np.ones_like(self.scoremat, dtype=bool)
                          if scoremask is None else scoremask)

    def __repr__(self):
        return (f"Scores(models={len(self.modelset)}, "
                f"segs={len(self.segset)})")


def fa_model_loop(batch_start, mini_batch_indices, factor_analyser,
                  stat0, stat1, e_h, e_hh):
    """Latent-factor E-step inner loop (reference ``PLDA_LDA.py:587``):
    fills per-model posterior means ``e_h`` and second moments ``e_hh``.
    Kept for API parity; ``PLDA.plda`` uses the vectorized equivalent."""
    F = factor_analyser.F
    rank = F.shape[1]
    a = F.T @ F
    inv_lambda_unique = {
        sess: linalg.inv(sess * a + np.eye(rank))
        for sess in np.unique(stat0[:, 0])}
    for idx in mini_batch_indices:
        inv_lambda = inv_lambda_unique[stat0[idx + batch_start, 0]]
        aux = F.T @ stat1[idx + batch_start]
        e_h[idx] = aux @ inv_lambda
        e_hh[idx] = inv_lambda + np.outer(e_h[idx], e_h[idx])


def _plda_score_parts(mu, F, Sigma, enroll_x, test_x, scaling_factor=1.0):
    """The reference's closed-form LLR pieces (``PLDA_LDA.py:712-755``)."""
    e = np.asarray(enroll_x, np.float64) - mu
    t = np.asarray(test_x, np.float64) - mu

    inv_sigma = linalg.inv(Sigma)
    i_spk = np.eye(F.shape[1], dtype="float")
    k = F.T @ (inv_sigma * scaling_factor) @ F
    k1 = linalg.inv(k + i_spk)
    k2 = linalg.inv(2 * k + i_spk)
    alpha1 = np.linalg.slogdet(k1)[1]
    alpha2 = np.linalg.slogdet(k2)[1]
    plda_cst = alpha2 / 2.0 - alpha1

    sigma_ac = F @ F.T
    sigma_tot = sigma_ac + Sigma
    sigma_tot_inv = linalg.inv(sigma_tot)
    tmp = linalg.inv(sigma_tot - sigma_ac @ sigma_tot_inv @ sigma_ac)
    phi = sigma_tot_inv - tmp
    psi = sigma_tot_inv @ sigma_ac @ tmp

    model_part = 0.5 * np.einsum("ij,ji->i", e @ phi, e.T)
    seg_part = 0.5 * np.einsum("ij,ji->i", t @ phi, t.T)
    scoremat = model_part[:, np.newaxis] + seg_part + plda_cst
    scoremat = (scoremat + e @ psi @ t.T) * scaling_factor
    return scoremat


def fast_PLDA_scoring(enroll, test, ndx, mu, F, Sigma, p_known=0.0,
                      scaling_factor=1.0, check_missing=True):
    """LLR scoring of enroll vs test x-vectors under a trained PLDA model —
    numerically identical to reference ``PLDA_LDA.py:650`` including the
    duplicate-model averaging, trial alignment, and the open-set
    ``p_known`` correction. ``ndx=None`` builds the full trial grid."""
    enroll_ctr = copy.deepcopy(enroll)
    test_ctr = copy.deepcopy(test)
    if ndx is None:
        ndx = Ndx(models=enroll_ctr.modelset, testsegs=test_ctr.segset)

    if not np.unique(enroll_ctr.modelset).shape == enroll_ctr.modelset.shape:
        enroll_ctr = enroll_ctr.mean_stat_per_model()

    if check_missing:
        clean_ndx = ndx.filter(enroll_ctr.modelset, test_ctr.segset, True)
        enroll_ctr.align_models(clean_ndx.modelset)
        test_ctr.align_segments(clean_ndx.segset)
    else:
        clean_ndx = ndx

    scoremat = _plda_score_parts(np.asarray(mu), np.asarray(F),
                                 np.asarray(Sigma), enroll_ctr.stat1,
                                 test_ctr.stat1, scaling_factor)

    if p_known != 0:
        n = scoremat.shape[0]
        tmp = np.exp(scoremat)
        open_set = np.empty_like(scoremat)
        for ii in range(n):
            open_set[ii] = scoremat[ii] - np.log(
                p_known * tmp[~(np.arange(n) == ii)].sum(axis=0) / (n - 1)
                + (1 - p_known))
        scoremat = open_set

    return Scores(scores=scoremat, modelset=clean_ndx.modelset,
                  segset=clean_ndx.segset, scoremask=clean_ndx.trialmask)


def _plda_llr_matrix(plda, enroll_x, test_x):
    """LLR matrix from raw vectors under a trained ``PLDA`` (doctest/test
    helper around the reference-exact scoring)."""
    return _plda_score_parts(plda.mean, plda.F, plda.Sigma, enroll_x, test_x,
                             plda.scaling_factor)
