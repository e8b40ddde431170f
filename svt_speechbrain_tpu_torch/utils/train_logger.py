"""Train loggers (port of ``FileTrainLogger``,
``svt_speechbrain_tpu/utils/train_logger.py:15``): one text line per stage
end, the same text as the JAX package's."""
from __future__ import annotations

import logging

logger = logging.getLogger(__name__)


class TrainLogger:
    def log_stats(self, stats_meta, train_stats=None, valid_stats=None,
                  test_stats=None, verbose=False):
        raise NotImplementedError


class FileTrainLogger(TrainLogger):
    """One line per epoch in a stats file (reference ``train_logger.py:44-99``);
    format: ``epoch: 3, lr: 1.00e-3 - train loss: 2.51 - valid loss: 2.30``.

    Example
    -------
    >>> import os, tempfile
    >>> d = tempfile.mkdtemp()
    >>> tl = FileTrainLogger(os.path.join(d, "log.txt"))
    >>> tl.log_stats({"epoch": 3, "lr": 0.001}, train_stats={"loss": 2.512},
    ...              valid_stats={"loss": 2.301}, verbose=False)
    >>> print(open(tl.save_file).read().strip())
    epoch: 3, lr: 1.00e-03 - train loss: 2.51 - valid loss: 2.30
    """

    def __init__(self, save_file, precision=2):
        self.save_file = save_file
        self.precision = precision

    def _item_to_string(self, key, value, dataset=None):
        if isinstance(value, float) and 1.0 < value < 100.0:
            value = f"{value:.{self.precision}f}"
        elif isinstance(value, float):
            value = f"{value:.{self.precision}e}"
        if dataset is not None:
            key = f"{dataset} {key}"
        return f"{key}: {value}"

    def _stats_to_string(self, stats, dataset=None):
        return ", ".join(self._item_to_string(k, v, dataset) for k, v in stats.items())

    def log_stats(self, stats_meta, train_stats=None, valid_stats=None,
                  test_stats=None, verbose=True):
        string_summary = self._stats_to_string(stats_meta)
        for dataset, stats in [("train", train_stats), ("valid", valid_stats),
                               ("test", test_stats)]:
            if stats is not None:
                string_summary += " - " + self._stats_to_string(stats, dataset)
        with open(self.save_file, "a") as fout:
            print(string_summary, file=fout)
        if verbose:
            logger.info(string_summary)
