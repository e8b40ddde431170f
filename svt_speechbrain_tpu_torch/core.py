"""The training engine, on one device (port of the training part of
``svt_speechbrain_tpu/core.py:195-715``).

A ``Brain`` subclass overrides ``compute_forward(batch, stage, rng)`` and
``compute_objectives(predictions, batch, stage)``; ``fit_batch`` runs one
optimization step as the JAX engine's jitted train step does:

1. the batch goes to the device, with ``valid_rows`` (all ones: one device,
   so no batch padding) for the models' whole-batch statistics;
2. the forward runs under train with the step's generators (``StepRNG``),
   through ``torch.func.functional_call`` with the compute parameters:
   frozen modules' parameters detached (the ``stop_gradient`` of static
   freezing), and with ``precision="bf16"`` every f32 parameter cast to
   bf16 (``_cast_for_compute``; a cast, not autocast, whose per-op rules
   differ — f32 batch arrays stay f32, as in the JAX engine);
3. the backward; the global norm of the trainable gradients; a clip by
   min(1, max_grad_norm / (norm + 1e-6)) (torch ``clip_grad_norm_``'s
   denominator);
4. a nonfinite loss or norm skips the step, and raises once more than
   ``nonfinite_patience`` steps have been skipped;
5. one step of each optimizer that owns a trainable module.

``fit``/``evaluate``, checkpoints, dataloaders and distribution wait for
later slices.
"""
from __future__ import annotations

import logging
import math
from enum import Enum, auto
from types import SimpleNamespace

import torch
from torch import nn

from svt_speechbrain_tpu_torch import resolve_device
from svt_speechbrain_tpu_torch.dataio.batch import PaddedData
from svt_speechbrain_tpu_torch.nnet.dropout import StepRNG

logger = logging.getLogger(__name__)


class Stage(Enum):
    """Stage of experiment: TRAIN, VALID, TEST (``core.py:62``)."""

    TRAIN = auto()
    VALID = auto()
    TEST = auto()


class _Forward(nn.Module):
    """Holds the brain's modules so that ``functional_call`` can swap in
    the compute parameters for one forward."""

    def __init__(self, modules, fn):
        super().__init__()
        self.mods = modules
        self.fn = fn

    def forward(self, *args):
        return self.fn(*args)


class Brain:
    """Training engine on one device (``core.py:195``).

    Arguments
    ---------
    modules : dict[str, torch.nn.Module]
        Named modules, with their weights; moved to the device.
    hparams : dict
        Experiment config, exposed as ``self.hparams.<key>``; ``seed``
        seeds the step generators.
    run_opts : dict
        ``device`` (CUDA unless a device is named), ``precision``
        ("fp32" | "bf16"), ``max_grad_norm``, ``nonfinite_patience``;
        run_opts take precedence over hparams, then the defaults.

    Example
    -------
    >>> import torch
    >>> from svt_speechbrain_tpu_torch.nnet.linear import Linear
    >>> class SimpleBrain(Brain):
    ...     def compute_forward(self, batch, stage, rng=None):
    ...         x, lens = batch["sig"]
    ...         return self.modules.model(x), lens
    ...     def compute_objectives(self, predictions, batch, stage):
    ...         y, _ = predictions
    ...         target, _ = batch["anno"]
    ...         return ((y - target) ** 2).mean()
    ...     def init_optimizers(self):
    ...         self.add_optimizer("opt", torch.optim.SGD, ["model"], lr=0.3)
    >>> model = Linear(2, 4)
    >>> brain = SimpleBrain({"model": model}, hparams={"seed": 0},
    ...                     run_opts={"device": "cpu"})
    >>> brain.init_optimizers()
    >>> gen = torch.Generator().manual_seed(0)
    >>> x = torch.randn(8, 5, 4, generator=gen)
    >>> lens = torch.ones(8)
    >>> batch = {"sig": PaddedData(x, lens),
    ...          "anno": PaddedData(x[..., :2] + x[..., 2:], lens)}
    >>> curve = [brain.fit_batch(batch) for _ in range(20)]
    >>> curve[-1] < 0.2 * curve[0]
    True
    """

    run_opt_defaults = {"device": None, "precision": "fp32",
                        "max_grad_norm": 5.0, "nonfinite_patience": 3}

    def __init__(self, modules=None, hparams=None, run_opts=None):
        run_opts = run_opts or {}
        hparams = hparams or {}
        for arg, default in self.run_opt_defaults.items():
            setattr(self, arg, run_opts.get(arg, hparams.get(arg, default)))
        if self.precision not in ("fp32", "bf16"):
            raise ValueError(f"precision must be fp32 or bf16, not "
                             f"{self.precision!r}")
        accum = run_opts.get("grad_accumulation_factor",
                             hparams.get("grad_accumulation_factor", 1))
        if accum != 1:
            # the JAX Brain splits each batch into micro-batches; ignoring
            # the option would train on other batches than the caller asked
            raise NotImplementedError(
                f"grad_accumulation_factor={accum!r}: gradient accumulation "
                f"is not ported yet (ROADMAP.md queue 1, item 10); only 1 "
                f"is accepted")
        self.device = resolve_device(self.device)
        self.hparams = SimpleNamespace(**hparams)
        self.modules = nn.ModuleDict(modules or {}).to(self.device)
        self._forward = _Forward(self.modules, self.compute_forward)
        seed = int(hparams.get("seed", 1986))
        self.generator = torch.Generator(self.device).manual_seed(seed)
        self.host_generator = torch.Generator().manual_seed(seed)
        self.optimizers = {}
        self.frozen_modules = frozenset()
        self.optimizer_step = 0
        self.nonfinite_count = 0
        self.last_grad_norm = None

    # ------------------------------------------------------------ overrides
    def compute_forward(self, batch, stage, rng=None):
        """Forward pass: (device batch, stage, ``StepRNG`` or None) →
        predictions, through ``self.modules``."""
        raise NotImplementedError

    def compute_objectives(self, predictions, batch, stage):
        """Loss computation: (predictions, device batch, stage) → scalar."""
        raise NotImplementedError

    # ----------------------------------------------------------- optimizers
    def init_optimizers(self):
        """Register optimizers with ``add_optimizer``."""

    def add_optimizer(self, name, factory, module_names, lr):
        """An optimizer ``factory(params, lr=lr)`` (a ``torch.optim`` class
        or a ``functools.partial`` of one) over ``module_names``' params."""
        params = [p for n in module_names for p in self.modules[n].parameters()]
        self.optimizers[name] = {"opt": factory(params, lr=lr),
                                 "modules": tuple(module_names)}

    def set_learning_rate(self, opt_name, lr):
        for group in self.optimizers[opt_name]["opt"].param_groups:
            group["lr"] = lr

    def get_learning_rate(self, opt_name):
        return float(self.optimizers[opt_name]["opt"].param_groups[0]["lr"])

    def set_frozen_modules(self, names):
        """Freeze modules by name (linear probing): their parameters take no
        gradient and their optimizers do not step."""
        unknown = set(names) - set(self.modules.keys())
        if unknown:
            raise ValueError(f"unknown modules {sorted(unknown)}")
        self.frozen_modules = frozenset(names)

    # ------------------------------------------------------------ the step
    def _batch_to_device(self, batch):
        def move(x):
            if isinstance(x, PaddedData):
                return PaddedData(move(x.data), move(x.lengths))
            x = torch.as_tensor(x)
            if x.dtype == torch.float64:
                x = x.float()
            return x.to(self.device, non_blocking=True)

        out = {key: move(val) for key, val in batch.items()}
        first = next(iter(out.values()))
        rows = (first.data if isinstance(first, PaddedData) else first).shape[0]
        out["valid_rows"] = torch.ones(rows, device=self.device)
        return out

    def _compute_params(self):
        """Parameter name → the tensor the forward uses: detached for a
        frozen module, cast to bf16 under ``precision="bf16"``."""
        params = {}
        for name, p in self._forward.named_parameters():
            if name.split(".")[1] in self.frozen_modules:
                p = p.detach()
            if self.precision == "bf16" and p.dtype == torch.float32:
                p = p.to(torch.bfloat16)
            params[name] = p
        return params

    def trainable_parameters(self):
        return [p for n, m in self.modules.items()
                if n not in self.frozen_modules for p in m.parameters()]

    def fit_batch(self, batch):
        """One optimization step (``core.py:593-715``); returns the loss.
        The step's gradient norm (before clipping) is kept in
        ``self.last_grad_norm``."""
        batch = self._batch_to_device(batch)
        rng = StepRNG(self.generator, self.host_generator)
        trainable = self.trainable_parameters()
        for p in trainable:
            p.grad = None
        preds = torch.func.functional_call(
            self._forward, self._compute_params(), (batch, Stage.TRAIN, rng))
        loss = self.compute_objectives(preds, batch, Stage.TRAIN).float()
        loss.backward()
        grads = [p.grad for p in trainable if p.grad is not None]
        # a sum of squares per leaf, as optax.global_norm: on the CPU,
        # torch's f32 vector_norm loses 2.5e-4 of the norm of an 8.4M-element
        # leaf (lv60's positional conv), a sum 1e-8
        squares = [g.float().square().sum() for g in grads]
        gnorm = torch.stack(
            squares + [torch.zeros((), device=self.device)]).sum().sqrt()
        loss_val, gnorm_val = torch.stack([loss.detach(), gnorm]).tolist()
        self.last_grad_norm = gnorm_val
        if not (math.isfinite(loss_val) and math.isfinite(gnorm_val)):
            self.nonfinite_count += 1
            logger.warning(f"Loss is {loss_val}, gradient norm {gnorm_val}. "
                           f"Step skipped ({self.nonfinite_count}/"
                           f"{self.nonfinite_patience}).")
            if self.nonfinite_count > self.nonfinite_patience:
                raise ValueError("Loss is not finite and patience is "
                                 "exhausted.")
            return loss_val
        clip = torch.clamp(self.max_grad_norm / (gnorm + 1e-6), max=1.0)
        torch._foreach_mul_(grads, clip)
        for cfg in self.optimizers.values():
            if any(n not in self.frozen_modules for n in cfg["modules"]):
                cfg["opt"].step()
        self.optimizer_step += 1
        return loss_val
