"""Learning-rate schedulers (a copy of ``svt_speechbrain_tpu/nnet/schedulers.py``).

Schedulers are small host-side objects with the same arithmetic as the JAX
package's, so both give the same sequence of values. ``update_learning_rate``
writes a value into a ``Brain``'s optimizer through ``set_learning_rate``,
which sets the ``lr`` of its ``torch.optim`` parameter groups.

All schedulers implement ``state_dict()`` / ``load_state_dict()`` so the
``Checkpointer`` can keep them.
"""
from __future__ import annotations

import math


class NewBobScheduler:
    """New-bob annealing on validation loss (same behavior as reference
    ``schedulers.py:55-146``): whenever the relative improvement over the
    previous epoch's metric falls below ``improvement_threshold``, burn one
    unit of patience; with patience exhausted, multiply the value by
    ``annealing_factor`` and refill patience. The first epoch never anneals
    (there is no previous metric to compare against).

    Example
    -------
    >>> sched = NewBobScheduler(initial_value=1.0)
    >>> sched(10.0)            # first epoch: never anneals
    (1.0, 1.0)
    >>> sched(5.0)             # improved: no anneal
    (1.0, 1.0)
    >>> sched(5.1)             # stalled: halve the value
    (1.0, 0.5)
    """

    def __init__(self, initial_value, annealing_factor=0.5,
                 improvement_threshold=0.0025, patient=0):
        self.hyperparam_value = initial_value
        self.annealing_factor = annealing_factor
        self.improvement_threshold = improvement_threshold
        self.patient = patient
        self.metric_values = []
        self.current_patient = patient

    def _stalled(self, metric_value):
        if not self.metric_values:
            return False
        last = self.metric_values[-1]
        gain = 0.0 if last == 0 else (last - metric_value) / last
        return gain < self.improvement_threshold

    def __call__(self, metric_value):
        """Returns ``(old_value, new_value)``."""
        old = self.hyperparam_value
        if self._stalled(metric_value):
            if self.current_patient > 0:
                self.current_patient -= 1
            else:
                self.hyperparam_value = old * self.annealing_factor
                self.current_patient = self.patient
        self.metric_values.append(metric_value)
        return old, self.hyperparam_value

    def state_dict(self):
        return {
            "hyperparam_value": self.hyperparam_value,
            "metric_values": list(self.metric_values),
            "current_patient": self.current_patient,
        }

    def load_state_dict(self, data):
        self.hyperparam_value = data["hyperparam_value"]
        self.metric_values = list(data["metric_values"])
        self.current_patient = data["current_patient"]


class LinearScheduler:
    """Linear interpolation between ``initial_value`` and ``final_value`` over
    ``epoch_count`` epochs (reference ``schedulers.py:148``).

    Example
    -------
    >>> sched = LinearScheduler(1.0, 0.0, epoch_count=3)
    >>> sched(1)
    (1.0, 0.5)
    >>> sched(2)
    (0.5, 0.0)
    """

    def __init__(self, initial_value, final_value, epoch_count):
        self.value_at_epoch = [
            initial_value + (final_value - initial_value) * i / max(epoch_count - 1, 1)
            for i in range(epoch_count)
        ]

    def __call__(self, current_epoch):
        old_index = max(0, min(current_epoch - 1, len(self.value_at_epoch) - 1))
        index = max(0, min(current_epoch, len(self.value_at_epoch) - 1))
        return self.value_at_epoch[old_index], self.value_at_epoch[index]

    def state_dict(self):
        return {}

    def load_state_dict(self, data):
        del data


class StepScheduler:
    """lr = initial * decay^floor(epoch / decay_drop) (reference ``schedulers.py:201``)."""

    def __init__(self, initial_value, decay_factor=0.5, decay_drop=2):
        self.initial_value = initial_value
        self.decay_factor = decay_factor
        self.decay_drop = decay_drop

    def _value(self, epoch):
        return self.initial_value * math.pow(
            self.decay_factor, math.floor((1 + epoch) / self.decay_drop)
        )

    def __call__(self, current_epoch):
        return self._value(current_epoch - 1), self._value(current_epoch)

    def state_dict(self):
        return {}

    def load_state_dict(self, data):
        del data


class NoamScheduler:
    """Transformer warmup/decay schedule, stepped per optimizer step
    (reference ``schedulers.py:397``)."""

    def __init__(self, lr_initial, n_warmup_steps, model_size=None):
        self.lr_initial = lr_initial
        self.n_warmup_steps = n_warmup_steps
        self.n_steps = 0
        self.normalize = n_warmup_steps ** 0.5
        if model_size is not None:
            self.normalize = model_size ** (-0.5)

    def __call__(self, *args):
        self.n_steps += 1
        current_lr = self.lr_initial * self._get_lr_scale()
        return current_lr, current_lr

    def _get_lr_scale(self):
        n, w = self.n_steps, self.n_warmup_steps
        return self.normalize * min(n ** (-0.5), n * w ** (-1.5))

    def state_dict(self):
        return {"n_steps": self.n_steps}

    def load_state_dict(self, data):
        self.n_steps = data["n_steps"]


class CyclicCosineScheduler:
    """Cosine-annealed cyclical lr (reference ``schedulers.py:464``)."""

    def __init__(self, n_warmup_steps, lr_initial=None, total_steps=100000):
        self.n_warmup_steps = n_warmup_steps
        self.lr_initial = lr_initial
        self.total = total_steps
        self.n_steps = 0

    def __call__(self, opt_lr=None):
        self.n_steps += 1
        lr0 = self.lr_initial if self.lr_initial is not None else opt_lr
        current_lr = lr0 * self._get_lr_scale()
        return current_lr, current_lr

    def _get_lr_scale(self):
        n, w = self.n_steps, self.n_warmup_steps
        return 0.5 * (math.cos(math.pi * (n - w) / self.total) + 1)

    def state_dict(self):
        return {"n_steps": self.n_steps}

    def load_state_dict(self, data):
        self.n_steps = data["n_steps"]


class ReduceLROnPlateau:
    """Plateau-based lr reduction (reference ``schedulers.py:539``): anneal by
    ``factor`` after ``patience`` consecutive non-improving epochs; never below
    ``dont_halve_until_epoch``."""

    def __init__(self, lr_min=1e-8, factor=0.5, patience=2, dont_halve_until_epoch=65):
        self.lr_min = lr_min
        self.factor = factor
        self.patience = patience
        self.patience_counter = 0
        self.losses = []
        self.dont_halve_until_epoch = dont_halve_until_epoch
        self.anchor = 99999

    def __call__(self, current_lr, epoch, current_loss):
        if epoch <= self.dont_halve_until_epoch:
            next_lr = current_lr
            self.anchor = current_loss
        else:
            if current_loss <= self.anchor:
                next_lr = current_lr
                self.anchor = current_loss
                self.patience_counter = 0
            elif self.patience_counter >= self.patience:
                next_lr = current_lr * self.factor
                self.patience_counter = 0
            else:
                next_lr = current_lr
                self.patience_counter += 1
        next_lr = max(next_lr, self.lr_min)
        self.losses.append(current_loss)
        return current_lr, next_lr

    def state_dict(self):
        return {
            "losses": list(self.losses),
            "anchor": self.anchor,
            "patience_counter": self.patience_counter,
        }

    def load_state_dict(self, data):
        self.losses = list(data["losses"])
        self.anchor = data["anchor"]
        self.patience_counter = data["patience_counter"]


class CyclicLRScheduler:
    """Triangular cyclical lr stepped per batch (reference ``schedulers.py:642``)."""

    def __init__(self, base_lr=0.001, max_lr=0.006, step_size=2000., mode="triangular",
                 gamma=1., scale_fn=None, scale_mode="cycle"):
        self.base_lr = base_lr
        self.max_lr = max_lr
        self.step_size = step_size
        self.mode = mode
        self.gamma = gamma
        if scale_fn is None:
            if self.mode == "triangular":
                self.scale_fn = lambda x: 1.0
                self.scale_mode = "cycle"
            elif self.mode == "triangular2":
                self.scale_fn = lambda x: 1 / (2.0 ** (x - 1))
                self.scale_mode = "cycle"
            elif self.mode == "exp_range":
                self.scale_fn = lambda x: gamma ** x
                self.scale_mode = "iterations"
            else:
                raise ValueError(f"unknown mode {mode}")
        else:
            self.scale_fn = scale_fn
            self.scale_mode = scale_mode
        self.clr_iterations = 0.0

    def _clr(self, clr_iterations):
        cycle = math.floor(1 + clr_iterations / (2 * self.step_size))
        x = abs(clr_iterations / self.step_size - 2 * cycle + 1)
        # the scale applies to the triangular component only — base_lr is
        # the floor every cycle returns to (reference schedulers.py:680-695)
        tri = (self.max_lr - self.base_lr) * max(0, (1 - x))
        if self.scale_mode == "cycle":
            return self.base_lr + tri * self.scale_fn(cycle)
        return self.base_lr + tri * self.scale_fn(clr_iterations)

    def on_batch_end(self):
        self.clr_iterations += 1
        return self._clr(self.clr_iterations)

    def state_dict(self):
        return {"clr_iterations": self.clr_iterations}

    def load_state_dict(self, data):
        self.clr_iterations = data["clr_iterations"]


def update_learning_rate(brain, new_lr, opt_name=None):
    """Set the learning rate of a Brain's optimizer ``opt_name``, or of all
    of them (``schedulers.py:280``)."""
    names = [opt_name] if opt_name else list(brain.optimizers)
    for name in names:
        brain.set_learning_rate(name, new_lr)
