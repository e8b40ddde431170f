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


class EpochCounterWithStopper(EpochCounter):
    """Early stopping on a tracked metric — reference-exact semantics
    (``epoch_loop.py:71-132``): ``should_stop(current, current_metric)``
    tracks the best metric with a relative ``min_delta = 1e-6`` threshold
    (``sign*metric < sign*((1-min_delta)*th)``), records the epoch it
    happened (``best_limit``), and stops once ``limit_to_stop`` epochs pass
    without a new best. Warmup epochs (``current <= limit_warmup``) never
    stop.

    Example
    -------
    >>> counter = EpochCounterWithStopper(limit=10, limit_to_stop=2,
    ...                                   limit_warmup=0, direction="min")
    >>> metrics = iter([5.0, 4.0, 4.0, 4.0, 3.0])
    >>> stopped_at = None
    >>> for epoch in counter:
    ...     if counter.should_stop(epoch, next(metrics)):
    ...         stopped_at = epoch
    ...         counter.current = counter.limit   # skip remaining epochs
    >>> stopped_at                                # best at 2, +2 patience
    4
    """

    def __init__(self, limit, limit_to_stop, limit_warmup, direction):
        super().__init__(limit)
        if limit_to_stop < 0:
            raise ValueError("Stopper 'limit_to_stop' must be >= 0")
        if limit_warmup < 0:
            raise ValueError("Stopper 'limit_warmup' must be >= 0")
        try:
            self.th, self.sign = {"min": (float("inf"), 1),
                                  "max": (-float("inf"), -1)}[direction]
        except KeyError:
            raise ValueError("Stopper 'direction' must be 'min' or 'max'")
        self.limit_to_stop = limit_to_stop
        self.limit_warmup = limit_warmup
        self.direction = direction
        self.best_limit = 0
        self.min_delta = 1e-6

    def should_stop(self, current, current_metric):
        """True once ``limit_to_stop`` epochs passed without a new best."""
        should_stop = False
        if current > self.limit_warmup:
            if self.sign * current_metric < self.sign * (
                    (1 - self.min_delta) * self.th):
                self.best_limit = current
                self.th = current_metric
            should_stop = (current - self.best_limit) >= self.limit_to_stop
        return should_stop

    def update_metric(self, current_metric):
        """Convenience wrapper: feed the epoch's metric; iteration stops
        automatically when ``should_stop`` fires (skip-to-limit like the
        reference's Example block)."""
        if self.should_stop(self.current, current_metric):
            self.current = self.limit

    def state_dict(self):
        return {"current": self.current, "best_limit": self.best_limit,
                "th": self.th}

    def load_state_dict(self, data, end_of_epoch=True):
        super().load_state_dict({"current": data["current"]}, end_of_epoch)
        self.best_limit = data["best_limit"]
        self.th = data["th"]
