"""Metric accumulation (port of ``svt_speechbrain_tpu/utils/metric_stats.py``).

``MetricStats``' metric is any callable giving one score per batch item,
such as a loss of ``nnet.losses`` with ``reduction="batch"`` (the AMT
recipe's onset and offset statistics); scores are kept as Python floats.
``BinaryMetricStats``, ``eer_threshold``/``EER``, ``minDCF`` and
``ErrorRateStats`` take numpy arrays or tensors (read through
``np.asarray``) and compute on the host in numpy, as the JAX package's do.
"""
from __future__ import annotations

import numpy as np


class MetricStats:
    """Accumulate a per-batch metric and summarize (reference
    ``metric_stats.py:16-153``). ``metric`` must return one score per batch
    item (the reference calls loss functions with ``reduction='batch'``).

    Example
    -------
    >>> import numpy as np
    >>> stats = MetricStats(metric=lambda p, t: np.abs(p - t).mean(axis=1))
    >>> stats.append(["u1", "u2"], np.asarray([[0.0, 1.0], [2.0, 2.0]]),
    ...              np.asarray([[0.0, 0.0], [0.0, 0.0]]))
    >>> s = stats.summarize()
    >>> s["average"], s["max_id"]
    (1.25, 'u2')
    """

    def __init__(self, metric, n_jobs=1, batch_eval=True):
        self.metric = metric
        self.n_jobs = n_jobs
        self.batch_eval = batch_eval
        self.clear()

    def clear(self):
        self.scores = []
        self.ids = []
        self.summary = {}

    def append(self, ids, *args, **kwargs):
        self.ids.extend(ids)
        if self.batch_eval:
            scores = self.metric(*args, **kwargs)
            scores = np.asarray(scores).reshape(-1)
            self.scores.extend(scores.tolist())
        else:
            for i in range(len(ids)):
                one_args = [a[i] for a in args]
                self.scores.append(float(self.metric(*one_args, **kwargs)))

    def summarize(self, field=None):
        min_index = int(np.argmin(self.scores)) if self.scores else 0
        max_index = int(np.argmax(self.scores)) if self.scores else 0
        self.summary = {
            "average": float(np.mean(self.scores)) if self.scores else 0.0,
            "min_score": float(self.scores[min_index]) if self.scores else 0.0,
            "min_id": self.ids[min_index] if self.ids else "",
            "max_score": float(self.scores[max_index]) if self.scores else 0.0,
            "max_id": self.ids[max_index] if self.ids else "",
        }
        if field is not None:
            return self.summary[field]
        return self.summary

    def write_stats(self, filestream, verbose=False):
        if not self.summary:
            self.summarize()
        message = f"Average score: {self.summary['average']}\n"
        message += f"Min error: {self.summary['min_score']} "
        message += f"id: {self.summary['min_id']}\n"
        message += f"Max error: {self.summary['max_score']} "
        message += f"id: {self.summary['max_id']}\n"
        filestream.write(message)
        if verbose:
            print(message)


class BinaryMetricStats:
    """Binary-classification metrics incl. EER threshold search
    (reference ``metric_stats.py:317``)."""

    def __init__(self, positive_label=1):
        self.positive_label = positive_label
        self.clear()

    def clear(self):
        self.ids = []
        self.scores = []
        self.labels = []
        self.summary = {}

    def append(self, ids, scores, labels):
        self.ids.extend(ids)
        self.scores.extend(np.asarray(scores).reshape(-1).tolist())
        self.labels.extend(np.asarray(labels).reshape(-1).tolist())

    def summarize(self, field=None, threshold=None, max_samples=None, beta=1, eps=1e-8):
        """Reference-exact summary (``metric_stats.py:347``): ``>=``
        thresholding, sorted strided subsampling under ``max_samples``,
        the reference's F-score formula, and eps INSIDE the MCC sqrt."""
        scores = np.asarray(self.scores, dtype=np.float32)
        labels = np.asarray(self.labels, dtype=np.float32)

        def subsample(v):
            # reference ``:399``: sort, then take every int(len/max)th
            if max_samples is not None and len(v) > max_samples:
                v = np.sort(v)
                v = v[list(range(0, len(v), int(len(v) / max_samples)))]
            return v

        if threshold is None:
            positive_scores = subsample(scores[labels == 1])
            negative_scores = subsample(scores[labels == 0])
            eer, threshold = eer_threshold(positive_scores, negative_scores)

        pred = (scores >= threshold).astype(np.float64)
        true = labels.astype(np.float64)
        tp = float(np.sum(pred * true))
        tn = float(np.sum((1 - pred) * (1 - true)))
        fp = float(np.sum(pred * (1 - true)))
        fn = float(np.sum((1 - pred) * true))
        self.summary = {
            "TP": tp, "TN": tn, "FP": fp, "FN": fn, "threshold": float(threshold),
            "FAR": fp / (fp + tn + eps),
            "FRR": fn / (tp + fn + eps),
            "DER": (fp + fn) / (tp + tn + eps),
            "precision": tp / (tp + fp + eps),
            "recall": tp / (tp + fn + eps),
            "F-score": (1.0 + beta ** 2.0) * tp
            / ((1.0 + beta ** 2.0) * tp + beta ** 2.0 * fn + fp),
            "MCC": (tp * tn - fp * fn)
            / ((tp + fp) * (tp + fn) * (tn + fp) * (tn + fn) + eps) ** 0.5,
        }
        if field is not None:
            return self.summary[field]
        return self.summary


def _det_thresholds(positive_scores, negative_scores):
    """Candidate thresholds: the unique scores PLUS their midpoints
    (reference ``metric_stats.py:474-480``)."""
    thresholds = np.sort(np.unique(np.concatenate([positive_scores,
                                                   negative_scores])))
    interm = (thresholds[:-1] + thresholds[1:]) / 2
    return np.sort(np.concatenate([thresholds, interm]))


def eer_threshold(positive_scores, negative_scores):
    """Equal-error-rate and its threshold — reference-exact
    (``metric_stats.py:455`` ``EER``): FRR counts ``pos <= thr``, FAR counts
    ``neg > thr``, candidates include score midpoints, EER is the mean of
    FAR/FRR at their closest point."""
    positive_scores = np.asarray(positive_scores, np.float32)
    negative_scores = np.asarray(negative_scores, np.float32)
    thresholds = _det_thresholds(positive_scores, negative_scores)
    frr = (positive_scores[:, None] <= thresholds[None, :]).mean(0)
    far = (negative_scores[:, None] > thresholds[None, :]).mean(0)
    min_index = int(np.argmin(np.abs(far - frr)))
    return float((far[min_index] + frr[min_index]) / 2), \
        float(thresholds[min_index])


def minDCF(positive_scores, negative_scores, c_miss=1.0, c_fa=1.0,
           p_target=0.01):
    """Minimum detection cost — reference-exact (``metric_stats.py:509``):
    ``min_thr c_miss·p_miss·p_target + c_fa·p_fa·(1-p_target)`` over the
    midpoint-augmented threshold grid, UNnormalized like the reference."""
    positive_scores = np.asarray(positive_scores, np.float32)
    negative_scores = np.asarray(negative_scores, np.float32)
    thresholds = _det_thresholds(positive_scores, negative_scores)
    p_miss = (positive_scores[:, None] <= thresholds[None, :]).mean(0)
    p_fa = (negative_scores[:, None] > thresholds[None, :]).mean(0)
    c_det = c_miss * p_miss * p_target + c_fa * p_fa * (1 - p_target)
    min_index = int(np.argmin(c_det))
    return float(c_det[min_index]), float(thresholds[min_index])


class ErrorRateStats(MetricStats):
    """Word/character error rate with alignments (reference
    ``metric_stats.py:189``). ``append`` takes padded prediction/target
    token batches (+ optional lengths and id→token decoders)."""

    def __init__(self, merge_tokens=False, split_tokens=False, space_token="_"):
        self.clear()
        self.merge_tokens = merge_tokens
        self.split_tokens = split_tokens
        self.space_token = space_token

    def clear(self):
        self.scores = []
        self.ids = []
        self.summary = {}

    def append(self, ids, predict, target, predict_len=None, target_len=None,
               ind2lab=None):
        from svt_speechbrain_tpu_torch.utils import edit_distance
        from svt_speechbrain_tpu_torch.utils.data_utils import undo_padding

        self.ids.extend(ids)
        if predict_len is not None:
            predict = undo_padding(predict, predict_len)
        if target_len is not None:
            target = undo_padding(target, target_len)
        if ind2lab is not None:
            predict = [ind2lab(u) for u in predict]
            target = [ind2lab(u) for u in target]
        if self.merge_tokens:
            predict = ["".join(str(s) for s in u).replace(self.space_token, " ").split()
                       for u in predict]
            target = ["".join(str(s) for s in u).replace(self.space_token, " ").split()
                      for u in target]
        if self.split_tokens:
            predict = [list("".join(str(s) for s in u)) for u in predict]
            target = [list("".join(str(s) for s in u)) for u in target]
        scores = edit_distance.wer_details_for_batch(ids, target, predict, True)
        self.scores.extend(scores)

    def summarize(self, field=None):
        from svt_speechbrain_tpu_torch.utils import edit_distance

        self.summary = edit_distance.wer_summary(self.scores)
        self.summary["error_rate"] = self.summary["WER"]
        if field is not None:
            return self.summary[field]
        return self.summary

    def write_stats(self, filestream):
        if not self.summary:
            self.summarize()
        print(f"%WER {self.summary['WER']:.2f} [ {self.summary['num_edits']} / "
              f"{self.summary['num_scored_tokens']}, "
              f"{self.summary['insertions']} ins, "
              f"{self.summary['deletions']} del, "
              f"{self.summary['substitutions']} sub ]", file=filestream)


def EER(positive_scores, negative_scores):
    """(eer, threshold) — reference ``metric_stats.py:455`` public API;
    thin wrapper over ``eer_threshold``."""
    eer, thr = eer_threshold(positive_scores, negative_scores)
    return eer, thr


def sequence_evaluation(metric, predict, target, **kwargs):
    """Evaluate ``metric`` id-by-id sequentially (reference
    ``metric_stats.py:175``)."""
    return [float(metric(p, t, **kwargs)) for p, t in zip(predict, target)]


def multiprocess_evaluation(metric, predict, target, n_jobs=1, **kwargs):
    """Reference ``metric_stats.py:155``: joblib fan-out. Host-side python
    metrics here are numpy and fast; a thread pool covers the parallel case
    without the joblib dependency."""
    if n_jobs <= 1:
        return sequence_evaluation(metric, predict, target, **kwargs)
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(max_workers=n_jobs) as ex:
        return list(ex.map(lambda pt: float(metric(pt[0], pt[1], **kwargs)),
                           zip(predict, target)))
