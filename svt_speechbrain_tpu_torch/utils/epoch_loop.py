"""Epoch counting (a copy of ``svt_speechbrain_tpu/utils/epoch_loop.py``)."""
from __future__ import annotations

import logging

logger = logging.getLogger(__name__)


class EpochCounter:
    """Checkpointable epoch iterator 1..limit (reference ``epoch_loop.py:16``).

    Example
    -------
    >>> counter = EpochCounter(limit=3)
    >>> [epoch for epoch in counter]
    [1, 2, 3]
    >>> counter.load_state_dict({"current": 1}, end_of_epoch=False)
    >>> next(counter)              # interrupted epoch 1 repeats
    1
    """

    def __init__(self, limit):
        self.current = 0
        self.limit = int(limit)

    def __iter__(self):
        return self

    def __next__(self):
        if self.current < self.limit:
            self.current += 1
            logger.info(f"Going into epoch {self.current}")
            return self.current
        raise StopIteration

    def state_dict(self):
        return {"current": self.current}

    def load_state_dict(self, data, end_of_epoch=True):
        self.current = data["current"]
        if not end_of_epoch:
            # repeat the interrupted epoch (reference ``epoch_loop.py:58-66``)
            self.current -= 1
