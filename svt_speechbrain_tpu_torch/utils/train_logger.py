"""Train loggers (port of ``svt_speechbrain_tpu/utils/train_logger.py``):
``FileTrainLogger`` writes one text line per stage end, the same text as the
JAX package's; ``TensorboardLogger`` and ``WandBLogger`` import their
package only when built. Every rank of a launch calls ``log_stats`` (the
brain's stage ends run on all of them); the main process alone logs."""
from __future__ import annotations

import logging

from svt_speechbrain_tpu_torch.parallel.distributed import if_main_process

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
        if not if_main_process():
            return
        string_summary = self._stats_to_string(stats_meta)
        for dataset, stats in [("train", train_stats), ("valid", valid_stats),
                               ("test", test_stats)]:
            if stats is not None:
                string_summary += " - " + self._stats_to_string(stats, dataset)
        with open(self.save_file, "a") as fout:
            print(string_summary, file=fout)
        if verbose:
            logger.info(string_summary)


class TensorboardLogger(TrainLogger):
    """TensorBoard event logging (``train_logger.py:59``) through torch's
    ``SummaryWriter``, imported when the logger is built: without the
    ``tensorboard`` package it raises ``ImportError`` naming it."""

    def __init__(self, save_dir):
        self.save_dir = save_dir
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError as e:
            raise ImportError("No tensorboard writer available: the "
                              "tensorboard package is needed") from e
        self.writer = SummaryWriter(self.save_dir)
        self.global_step = {"train": {}, "valid": {}, "test": {}, "meta": 0}

    def log_stats(self, stats_meta, train_stats=None, valid_stats=None,
                  test_stats=None, verbose=False):
        if not if_main_process():
            return
        self.global_step["meta"] += 1
        for name, value in stats_meta.items():
            if isinstance(value, (int, float)):
                self.writer.add_scalar(name, value, self.global_step["meta"])
        for dataset, stats in [("train", train_stats), ("valid", valid_stats),
                               ("test", test_stats)]:
            if stats is None:
                continue
            for stat, value_list in stats.items():
                if stat not in self.global_step[dataset]:
                    self.global_step[dataset][stat] = 0
                if not isinstance(value_list, (list, tuple)):
                    value_list = [value_list]
                for value in value_list:
                    new_global_step = self.global_step[dataset][stat] + 1
                    self.writer.add_scalar(f"{dataset}/{stat}", value, new_global_step)
                    self.global_step[dataset][stat] = new_global_step


class WandBLogger(TrainLogger):
    """Weights & Biases logging (``train_logger.py:96``): ``wandb`` is
    imported when the logger is built, and its absence raises
    ``ImportError`` naming it."""

    def __init__(self, initializer=None, *args, **kwargs):
        try:
            import wandb
        except ImportError as e:
            raise ImportError("wandb is not available") from e
        if initializer is None:
            initializer = wandb.init
        self.run = initializer(*args, **kwargs)

    def log_stats(self, stats_meta, train_stats=None, valid_stats=None,
                  test_stats=None, verbose=False):
        if not if_main_process():
            return
        logs = {}
        for dataset, stats in [("train", train_stats), ("valid", valid_stats),
                               ("test", test_stats)]:
            if stats is not None:
                logs[dataset] = stats
        step = stats_meta.get("epoch", None)
        if step is not None:
            self.run.log({**logs, **stats_meta}, step=step)
        else:
            self.run.log({**logs, **stats_meta})
