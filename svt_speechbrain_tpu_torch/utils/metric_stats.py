"""Metric accumulation (port of ``MetricStats``,
``svt_speechbrain_tpu/utils/metric_stats.py:7``).

The metric is any callable giving one score per batch item, such as a loss
of ``nnet.losses`` with ``reduction="batch"`` (the AMT recipe's onset and
offset statistics); scores are kept as Python floats.
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
