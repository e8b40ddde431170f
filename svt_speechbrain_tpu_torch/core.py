"""The training engine (port of ``svt_speechbrain_tpu/core.py``).

A ``Brain`` subclass overrides ``compute_forward(batch, stage, rng)`` and
``compute_objectives(predictions, batch, stage)``, and is driven by ``fit``
(epochs of ``fit_batch`` over a train loader, each followed by
``evaluate_batch`` over a valid loader) and ``evaluate`` (a test loader).
Loaders are ``dataio.dataloader.SaveableDataLoader``s of ``PaddedBatch``es,
built by ``make_dataloader`` with the stage's defaults.

``fit_batch`` runs one optimization step as the JAX engine's jitted train
step does:

1. the batch goes to the device (keys in ``host_only_keys`` stay on the
   host), with ``valid_rows`` for the models' whole-batch statistics: all
   ones, unless ``grad_accumulation_factor`` pads the batch (below);
2. the forward runs under train with the step's generators (``StepRNG``),
   through ``torch.func.functional_call`` with the compute parameters:
   frozen modules' parameters detached (the ``stop_gradient`` of static
   freezing), and with ``precision="bf16"`` every f32 parameter cast to
   bf16 (``_compute_params``; a cast, not autocast, whose per-op rules
   differ — f32 batch arrays stay f32, as in the JAX engine);
3. the backward; the global norm of the trainable gradients; a clip by
   min(1, max_grad_norm / (norm + 1e-6)) (torch ``clip_grad_norm_``'s
   denominator);
4. a nonfinite loss or norm skips the step, and raises once more than
   ``nonfinite_patience`` steps have been skipped;
5. one step of each optimizer that owns a trainable module.

With ``grad_accumulation_factor`` N above 1 (``max(int(N), 1)``, as the JAX
step), the batch is padded with zero rows (relative length 0, and 0 in
``valid_rows``) up to a multiple of N and split into N contiguous
micro-batches; steps 2-3's forward and backward run on each in turn, with
its own generator draws and the BatchNorm statistics the previous one left;
the gradients are summed and divided by N, the loss is the mean of the
micro-batch losses, and the norm, clip, nonfinite check and optimizer steps
run once. A micro-batch of padding rows only adds 0 to the masked losses;
where a model normalizes over its valid rows (wav2vec2's input norm) that
micro-batch's gradient is NaN, and the step is skipped, as in the JAX step.

``evaluate_batch`` runs the forward and the objectives under
``torch.inference_mode`` with the same compute parameters, brings the
predictions to the host in one copy and hands them, as numpy, to
``on_evaluate_batch_end``.

A ``checkpointer`` gets every module, every optimizer (``<name>_opt``), the
train loader's position and the brain's counters with both generators'
states, so that a run recovered from a checkpoint continues with the numbers
of an uninterrupted one.

Under a launch of more than one process (``torchrun``; the group set up by
``parallel.distributed.ddp_init_group``) the brain trains data-parallel,
one process per device, where the JAX engine shards one program's batch
over a device mesh: each rank loads its part of the train set
(``DistributedSamplerWrapper``), the forward runs through
``DistributedDataParallel`` over the trainable modules (frozen ones stay out
of it and of the optimizers), and the gradient all-reduce weighs each rank
by its valid rows, so the step is the step on the whole batch. Accumulated
micro-batches but the last run under ``no_sync``. The loss, and with it the
nonfinite skip, is agreed over the ranks. With the ``fsdp`` run option the
modules are fully sharded instead (``parallel.fsdp.apply_fsdp``: FSDP2 over
a "data" mesh of every rank); the forward then runs on the sharded modules
themselves, frozen modules by ``requires_grad`` and bf16 by FSDP2's
``MixedPrecisionPolicy``. Every rank runs the stage ends, so that an
annealed learning rate is every rank's (the JAX loop runs the validation
stage end on the main process only), and every rank calls the
checkpointer, whose main process alone writes; under ``fsdp`` each module
and optimizer state is gathered whole first (``_FullState``), so the files
are those of one process.
"""
from __future__ import annotations

import argparse
import contextlib
import inspect
import logging
import math
import os
import shutil
import sys
import time
from datetime import date
from enum import Enum, auto
from types import SimpleNamespace

import numpy as np
import torch
from torch import nn
from torch.utils._pytree import tree_map

from svt_speechbrain_tpu_torch import resolve_device
from svt_speechbrain_tpu_torch.config import convert_to_yaml
from svt_speechbrain_tpu_torch.convert_jax import init_modules, is_unseeded
from svt_speechbrain_tpu_torch.dataio.batch import PaddedBatch, PaddedData
from svt_speechbrain_tpu_torch.dataio.dataloader import (LoopedLoader,
                                                         SaveableDataLoader,
                                                         make_dataloader)
from svt_speechbrain_tpu_torch.dataio.sampler import (
    DistributedSamplerWrapper, ReproducibleRandomSampler)
from svt_speechbrain_tpu_torch.nnet.dropout import StepRNG
from svt_speechbrain_tpu_torch.parallel.distributed import (if_main_process,
                                                            run_on_main)
from svt_speechbrain_tpu_torch.utils.logger import (
    format_order_of_magnitude, get_environment_description, setup_logging)

logger = logging.getLogger(__name__)

DEFAULT_LOG_CONFIG = None
INTRA_EPOCH_CKPT_FLAG = "brain_intra_epoch_ckpt"


class Stage(Enum):
    """Stage of experiment: TRAIN, VALID, TEST (``core.py:62``)."""

    TRAIN = auto()
    VALID = auto()
    TEST = auto()


def create_experiment_directory(experiment_directory, hyperparams_to_save=None,
                                overrides={}, log_config=DEFAULT_LOG_CONFIG,
                                save_env_desc=True):
    """Create the experiment folder (``core.py:85``), on the main process:
    the hyperparameter file with a header naming it and the overrides, a
    copy of the calling script, ``log.txt`` (logging is set up to it) and
    ``env.log``. ``log_config`` is accepted and unused, as in the JAX
    package: logging is always ``utils.logger.setup_logging``'s."""
    caller = inspect.getmodule(inspect.currentframe().f_back)

    def _create():
        os.makedirs(experiment_directory, exist_ok=True)
        if hyperparams_to_save is not None:
            with open(hyperparams_to_save) as f:
                resolved_yaml = f.read()
            with open(os.path.join(experiment_directory, "hyperparams.yaml"),
                      "w") as w:
                w.write(f"# Generated {date.today()} from:\n")
                w.write(f"# {os.path.abspath(hyperparams_to_save)}\n")
                w.write("# yamllint disable\n")
                if overrides:
                    w.write("# Overrides:\n")
                    for line in str(overrides).splitlines():
                        w.write(f"#   {line}\n")
                w.write(resolved_yaml)
        callingfile = getattr(caller, "__file__", None)
        if callingfile and os.path.exists(callingfile):
            shutil.copy(os.path.realpath(callingfile), experiment_directory)
        setup_logging(os.path.join(experiment_directory, "log.txt"))
        sys.excepthook = _logging_excepthook
        logger.info("Beginning experiment!")
        logger.info(f"Experiment folder: {experiment_directory}")
        if save_env_desc:
            with open(os.path.join(experiment_directory, "env.log"), "w") as fo:
                fo.write(get_environment_description())

    run_on_main(_create)


def _logging_excepthook(exc_type, exc_value, exc_traceback):
    """Log an uncaught exception into the experiment's log."""
    logger.error("Exception:", exc_info=(exc_type, exc_value, exc_traceback))


# flags of the JAX command line that configure XLA: refused
_TPU_ONLY = {"jit_module_keys": "--jit_module_keys (XLA compilation)"}


def parse_arguments(arg_list=None):
    """Parse ``experiment.py params.yaml --overrides`` (``core.py:133``) into
    (param_file, run_opts dict, overrides yaml string); run options not
    given are left out, so the hyperparameter file's values apply.
    ``--device`` is ``cuda`` unless named. The JAX package's TPU flags
    (``--jit_module_keys``, ``--distributed_backend ici``) are refused. A
    ``--data_parallel_count`` N above 1 is a launch of N processes: given
    outside one (``WORLD_SIZE`` other than N) it raises, naming
    ``torchrun``.

    Example
    -------
    >>> param_file, run_opts, overrides = parse_arguments(
    ...     ["hparams.yaml", "--device", "cpu", "--lr=0.1"])
    >>> param_file, run_opts["device"], "precision" in run_opts, overrides
    ('hparams.yaml', 'cpu', False, 'lr: 0.1')
    """
    if arg_list is None:
        arg_list = sys.argv[1:]
    parser = argparse.ArgumentParser(description="Run an experiment")
    parser.add_argument("param_file", type=str,
                        help="A yaml-formatted file using the extended YAML "
                             "syntax.")
    parser.add_argument("--debug", default=False, action="store_true",
                        help="Run the experiment with only a few batches for "
                             "all datasets, to ensure code runs without "
                             "crashing.")
    parser.add_argument("--debug_batches", type=int, default=2,
                        help="Number of batches to run in debug mode.")
    parser.add_argument("--debug_epochs", type=int, default=2,
                        help="Number of epochs to run in debug mode.")
    parser.add_argument("--log_config", type=str,
                        help="Logging config file path")
    parser.add_argument("--device", type=str, default="cuda",
                        help="Torch device to run on (cuda, cuda:1, cpu)")
    parser.add_argument("--data_parallel_count", type=int, default=-1,
                        help="Number of processes of the launch (torchrun)")
    parser.add_argument("--fsdp", default=None, action="store_true",
                        help="Fully shard parameters and optimizer state "
                             "over the ranks (FSDP2)")
    parser.add_argument("--distributed_launch", default=False,
                        action="store_true",
                        help="Set up a process group")
    parser.add_argument("--distributed_backend", type=str, default=None,
                        help="torch.distributed backend (nccl on cuda, "
                             "gloo on the cpu by default)")
    parser.add_argument("--find_unused_parameters", default=None,
                        action="store_true",
                        help="DistributedDataParallel: find the parameters "
                             "a forward left unused")
    parser.add_argument("--jit_module_keys", type=str, nargs="*",
                        help="XLA compilation of modules: refused")
    parser.add_argument("--precision", type=str, default=None,
                        choices=["fp32", "bf16"], help="Compute precision")
    parser.add_argument("--auto_mix_prec", default=None, action="store_true",
                        help="Alias for --precision bf16")
    parser.add_argument("--max_grad_norm", type=float, default=None,
                        help="Gradient norm clipping threshold")
    parser.add_argument("--nonfinite_patience", type=int, default=None,
                        help="Number of batches to accept nonfinite loss "
                             "values")
    parser.add_argument("--noprogressbar", default=None, action="store_true",
                        help="Disable the progress bar")
    parser.add_argument("--ckpt_interval_minutes", type=float, default=None,
                        help="Save intra-epoch checkpoints every N minutes")
    parser.add_argument("--grad_accumulation_factor", type=int, default=None,
                        help="Number of batches to accumulate gradients over")

    run_opts, overrides = parser.parse_known_args(arg_list)
    run_opts = vars(run_opts)
    for flag, what in _TPU_ONLY.items():
        if run_opts[flag]:
            parser.error(f"{what} configures the JAX package on a TPU and has "
                         f"no meaning in the PyTorch port")
    if run_opts["distributed_backend"] == "ici":
        parser.error("--distributed_backend ici is the TPU interconnect; the "
                     "PyTorch port takes a torch.distributed backend")
    count = run_opts["data_parallel_count"]
    if count > 1 and int(os.environ.get("WORLD_SIZE", "1")) != count:
        parser.error(f"--data_parallel_count {count} is a launch of {count} "
                     f"processes, one a device: run it under torchrun "
                     f"--nproc_per_node {count}")
    param_file = run_opts.pop("param_file")
    overrides = convert_to_yaml(overrides)
    run_opts = {k: v for k, v in run_opts.items()
                if v is not None and k not in _TPU_ONLY}
    if run_opts.pop("auto_mix_prec", None):
        run_opts["precision"] = "bf16"
    return param_file, run_opts, overrides


def _map_rows(batch, rows, fn):
    """``batch`` with ``fn`` applied to every tensor (and ``PaddedData``
    part) whose first axis has ``rows`` entries."""
    def apply(x):
        if isinstance(x, PaddedData):
            return PaddedData(apply(x.data), apply(x.lengths))
        return fn(x) if x.ndim >= 1 and x.shape[0] == rows else x

    return {key: apply(val) for key, val in batch.items()}


class _Forward(nn.Module):
    """Holds the brain's modules so that ``functional_call`` can swap in
    the compute parameters for one forward."""

    def __init__(self, modules, fn):
        super().__init__()
        self.mods = modules
        self.fn = fn

    def forward(self, *args):
        return self.fn(*args)


def _progress(iterable, enable):
    """``iterable`` under a tqdm bar when ``enable`` (tqdm is imported only
    then), else itself."""
    if not enable:
        return iterable
    from tqdm import tqdm

    return tqdm(iterable, dynamic_ncols=True)


def _world_size():
    import torch.distributed as dist

    return (dist.get_world_size()
            if dist.is_available() and dist.is_initialized() else 1)


def _local(t):
    """The rank's own part of a tensor (a DTensor's local shard)."""
    return t.to_local() if hasattr(t, "to_local") else t


class Brain:
    """Training and evaluation engine (``core.py:195``), on one device or
    data-parallel over the ranks of a launch.

    Arguments
    ---------
    modules : dict[str, torch.nn.Module]
        Named modules, with their weights; moved to the device.
    opt_class : callable or None
        ``opt_class(params)`` builds the one optimizer over every module
        when ``init_optimizers`` is not overridden.
    hparams : dict
        Experiment config, exposed as ``self.hparams.<key>``; ``seed``
        seeds the step generators and the train loader's shuffling.
    run_opts : dict
        ``device`` (CUDA unless a device is named), ``precision``
        ("fp32" | "bf16"), ``max_grad_norm``, ``nonfinite_patience``,
        ``debug``/``debug_batches``/``debug_epochs``, ``noprogressbar``,
        ``ckpt_interval_minutes``, ``fsdp``, ``find_unused_parameters``
        (for ``DistributedDataParallel``); run_opts take precedence over
        hparams, then the defaults.
    checkpointer : utils.checkpoints.Checkpointer or None
        Gets the modules, the optimizers, the train loader's position and
        the brain's counters and generator states.

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
    ...                     run_opts={"device": "cpu", "noprogressbar": True})
    >>> gen = torch.Generator().manual_seed(0)
    >>> data = []
    >>> for i in range(16):
    ...     x = torch.randn(5, 4, generator=gen)
    ...     data.append({"id": str(i), "sig": x, "anno": x[:, :2] + x[:, 2:]})
    >>> from svt_speechbrain_tpu_torch.utils.epoch_loop import EpochCounter
    >>> brain.fit(EpochCounter(10), data, train_loader_kwargs={"batch_size": 8})
    >>> brain.train_loss < 0.2 * brain.evaluate(data[:1]) + 0.05
    True
    """

    run_opt_defaults = {"device": None, "precision": "fp32",
                        "max_grad_norm": 5.0, "nonfinite_patience": 3,
                        "debug": False, "debug_batches": 2, "debug_epochs": 2,
                        "noprogressbar": False, "ckpt_interval_minutes": 0,
                        "grad_accumulation_factor": 1, "fsdp": False,
                        "find_unused_parameters": False}

    def __init__(self, modules=None, opt_class=None, hparams=None,
                 run_opts=None, checkpointer=None):
        run_opts = run_opts or {}
        hparams = hparams or {}
        for arg, default in self.run_opt_defaults.items():
            setattr(self, arg, run_opts.get(arg, hparams.get(arg, default)))
        if self.precision not in ("fp32", "bf16"):
            raise ValueError(f"precision must be fp32 or bf16, not "
                             f"{self.precision!r}")
        self.grad_accumulation_factor = max(
            int(self.grad_accumulation_factor), 1)
        self.device = resolve_device(self.device)
        self.opt_class = opt_class
        self.checkpointer = checkpointer
        self.hparams = SimpleNamespace(**hparams)
        self.modules = nn.ModuleDict(modules or {}).to(self.device)
        self._forward = _Forward(self.modules, self.compute_forward)
        self.seed = int(hparams.get("seed", 1986))
        # the JAX Brain draws every module from its init; here the modules
        # that no one loaded or seeded are drawn, in order, from the seed
        init_modules({name: m for name, m in self.modules.items()
                      if is_unseeded(m)}, self.seed)
        self.world_size = _world_size()
        self._ddp = self._ddp_frozen = None
        if self.fsdp:
            self._shard_modules()
        self.generator = torch.Generator(self.device).manual_seed(self.seed)
        self.host_generator = torch.Generator().manual_seed(self.seed)
        self.optimizers = {}
        self.frozen_modules = frozenset()
        self.avg_train_loss = 0.0
        self.step = 0
        self.optimizer_step = 0
        self.nonfinite_count = 0
        self.last_grad_norm = None
        self.train_sampler = None
        # batch keys that never go to the device (per-song references)
        self.host_only_keys = set()
        if checkpointer is not None:
            checkpointer.add_recoverable("brain", _BrainCounters(self))
            for name, module in self.modules.items():
                checkpointer.add_recoverable(
                    name, _FullState(module) if self.fsdp else module)
        total = sum(p.numel() for p in self.modules.parameters())
        if total > 0:
            num, units = format_order_of_magnitude(total)
            logger.info(f"{num}{units} trainable parameters in "
                        f"{type(self).__name__}")

    # ------------------------------------------------------------ overrides
    def compute_forward(self, batch, stage, rng=None):
        """Forward pass: (device batch, stage, ``StepRNG`` or None) →
        predictions, through ``self.modules``."""
        raise NotImplementedError

    def compute_objectives(self, predictions, batch, stage):
        """Loss computation: (predictions, device batch, stage) → scalar."""
        raise NotImplementedError

    def on_stage_start(self, stage, epoch=None):
        """Called at the start of each TRAIN/VALID/TEST stage."""

    def on_stage_end(self, stage, stage_loss, epoch=None):
        """Called at the end of each stage."""

    def on_fit_start(self):
        """Called once at the start of ``fit``: the optimizers, then the
        newest checkpoint if there is one (``core.py:404``)."""
        self.init_optimizers()
        if self.checkpointer is not None:
            self.checkpointer.recover_if_possible()

    def on_evaluate_start(self, max_key=None, min_key=None):
        """Recover the best checkpoint by key (``core.py:411``)."""
        if self.checkpointer is not None:
            self.checkpointer.recover_if_possible(max_key=max_key,
                                                  min_key=min_key)

    def on_evaluate_batch_end(self, batch, predictions, loss, stage):
        """Host-side evaluation hook: ``batch`` as the loader gave it,
        ``predictions`` as numpy, ``loss`` a float."""

    # ----------------------------------------------------------- optimizers
    def init_optimizers(self):
        """Register optimizers with ``add_optimizer``; by default one
        ``opt_class`` over every module."""
        if self.opt_class is not None:
            self.add_optimizer("opt", self.opt_class, list(self.modules.keys()))

    def add_optimizer(self, name, factory, module_names, lr=None):
        """An optimizer ``factory(params, lr=lr)`` (a ``torch.optim`` class
        or a ``functools.partial`` of one; ``factory(params)`` without
        ``lr``) over ``module_names``' params, checkpointed as
        ``<name>_opt``."""
        params = [p for n in module_names for p in self.modules[n].parameters()]
        opt = factory(params) if lr is None else factory(params, lr=lr)
        self.optimizers[name] = {"opt": opt, "modules": tuple(module_names)}
        if self.checkpointer is not None:
            self.checkpointer.add_recoverable(
                f"{name}_opt", _FullState(opt) if self.fsdp else opt)

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
        if self.fsdp:
            for name, module in self.modules.items():
                module.requires_grad_(name not in self.frozen_modules)

    # ------------------------------------------------------- data parallel
    def _shard_modules(self):
        """Every module with parameters fully sharded over a "data" mesh of
        all ranks (``parallel.fsdp.apply_fsdp``)."""
        import torch.distributed as dist
        from torch.distributed.fsdp import MixedPrecisionPolicy

        from svt_speechbrain_tpu_torch.parallel.fsdp import apply_fsdp
        from svt_speechbrain_tpu_torch.parallel.mesh import make_mesh

        if not (dist.is_available() and dist.is_initialized()):
            raise RuntimeError("fsdp shards over the ranks of a process "
                               "group: launch with torchrun (ddp_init_group)")
        self.mesh = make_mesh()
        kwargs = {}
        if self.precision == "bf16":
            kwargs["mp_policy"] = MixedPrecisionPolicy(
                param_dtype=torch.bfloat16, reduce_dtype=torch.float32,
                cast_forward_inputs=False)
        for module in self.modules.values():
            if next(module.parameters(), None) is not None:
                apply_fsdp(module, self.mesh, **kwargs)

    def _data_parallel(self):
        """``DistributedDataParallel`` over the brain's modules, built
        again when the frozen modules change: their parameters are left out
        of it."""
        from torch.nn.parallel import DistributedDataParallel

        if self._ddp is None or self._ddp_frozen != self.frozen_modules:
            ignore = [f"mods.{n}.{k}" for n in self.frozen_modules
                      for k, _ in self.modules[n].named_parameters()]
            DistributedDataParallel._set_params_and_buffers_to_ignore_for_model(
                self._forward, ignore)
            self._ddp = DistributedDataParallel(
                self._forward, broadcast_buffers=False,
                find_unused_parameters=self.find_unused_parameters,
                device_ids=([self.device.index] if self.device.type == "cuda"
                            else None))
            self._ddp_frozen = self.frozen_modules
        return self._ddp

    def _call_forward(self, batch, stage, rng):
        """``compute_forward`` on the compute parameters; a training
        forward of several ranks through ``DistributedDataParallel``, or on
        the sharded modules themselves under ``fsdp``."""
        if self.fsdp:
            return self._forward(batch, stage, rng)
        params = self._compute_params()
        module = self._forward
        if self.world_size > 1 and stage == Stage.TRAIN:
            module = self._data_parallel()
            params = {"module." + k: v for k, v in params.items()}
        return torch.func.functional_call(module, params, (batch, stage, rng))

    # ------------------------------------------------------------- batching
    def make_dataloader(self, dataset, stage, ckpt_prefix="dataloader-",
                        **loader_kwargs):
        """A loader with the stage's defaults (``core.py:479``): a seeded
        ``ReproducibleRandomSampler`` for a shuffled train set, pinned
        batches on CUDA, and the position checkpointed as
        ``<ckpt_prefix><STAGE>``. A train ``batch_sampler`` is handed to the
        loader as it is, with no sampler beside it (each rank then draws
        every batch, as in the JAX package), and ``fit``'s ``set_epoch``
        reaches it."""
        loader_kwargs = dict(loader_kwargs)
        if stage == Stage.TRAIN and \
                loader_kwargs.get("batch_sampler") is not None:
            self.train_sampler = loader_kwargs["batch_sampler"]
        elif stage == Stage.TRAIN:
            if loader_kwargs.pop("shuffle", False) and \
                    loader_kwargs.get("sampler") is None:
                loader_kwargs["sampler"] = ReproducibleRandomSampler(
                    dataset, seed=self.seed)
            if self.world_size > 1:             # each rank its own part
                loader_kwargs["sampler"] = DistributedSamplerWrapper(
                    loader_kwargs.get("sampler")
                    or torch.utils.data.SequentialSampler(dataset))
            self.train_sampler = loader_kwargs.get("sampler")
        loader_kwargs.setdefault("pin_memory", self.device.type == "cuda")
        dataloader = make_dataloader(dataset, **loader_kwargs)
        if (self.checkpointer is not None and ckpt_prefix is not None
                and isinstance(dataloader, (SaveableDataLoader,
                                            LoopedLoader))):
            self.checkpointer.add_recoverable(ckpt_prefix + stage.name,
                                              dataloader)
        return dataloader

    def _batch_to_device(self, batch, accum=1):
        """The device batch with ``valid_rows``; with ``accum`` above 1 the
        rows are padded with zeros to a multiple of ``accum``
        (``core.py:509``)."""
        def move(x):
            if isinstance(x, PaddedData):
                return PaddedData(move(x.data), move(x.lengths))
            x = torch.as_tensor(x)
            if x.dtype == torch.float64:
                x = x.float()
            return x.to(self.device, non_blocking=True)

        if isinstance(batch, PaddedBatch):
            batch = batch.tensors()
        out = {key: move(val) for key, val in batch.items()
               if key not in self.host_only_keys}
        first = next(iter(out.values()))
        rows = (first.data if isinstance(first, PaddedData) else first).shape[0]
        target = -(-rows // accum) * accum
        valid = torch.ones(rows, device=self.device)
        if target != rows:
            out = _map_rows(out, rows, lambda x: torch.cat(
                [x, x.new_zeros((target - rows,) + x.shape[1:])]))
            valid = torch.cat([valid, valid.new_zeros(target - rows)])
        out["valid_rows"] = valid
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

    # ------------------------------------------------------------ the steps
    def fit_batch(self, batch):
        """One optimization step (``core.py:692``); returns the loss.
        The step's gradient norm (before clipping) is kept in
        ``self.last_grad_norm``."""
        accum = self.grad_accumulation_factor
        batch = self._batch_to_device(batch, accum)
        rows = batch["valid_rows"].shape[0] // accum
        trainable = self.trainable_parameters()
        for p in trainable:
            p.grad = None
        # several ranks: each rank's loss counts by its valid rows
        ranks = self.world_size > 1
        weight = batch["valid_rows"].sum() if ranks else None
        ddp = self._data_parallel() if ranks and not self.fsdp else None
        loss = None
        for i in range(accum):
            micro = batch if accum == 1 else _map_rows(
                batch, accum * rows, lambda x: x[i * rows:(i + 1) * rows])
            rng = StepRNG(self.generator, self.host_generator)
            sync = (ddp.no_sync() if ddp is not None and i < accum - 1
                    else contextlib.nullcontext())
            with sync:
                preds = self._call_forward(micro, Stage.TRAIN, rng)
                micro_loss = self.compute_objectives(preds, micro,
                                                     Stage.TRAIN).float()
                (micro_loss * weight if ranks else micro_loss).backward()
            loss = micro_loss.detach() if loss is None \
                else loss + micro_loss.detach()
        if self.fsdp:       # a frozen module has no backward to reshard it
            for module in self.modules.values():
                if hasattr(module, "reshard"):
                    module.reshard()
        grads = [_local(p.grad) for p in trainable if p.grad is not None]
        if accum > 1:
            loss = loss / accum
            torch._foreach_div_(grads, accum)
        if ranks:
            loss = self._agree(loss, weight, grads)
        # a sum of squares per leaf, as optax.global_norm: on the CPU,
        # torch's f32 vector_norm loses 2.5e-4 of the norm of an 8.4M-element
        # leaf (lv60's positional conv), a sum 1e-8
        squares = [g.float().square().sum() for g in grads]
        gnorm_sq = torch.stack(
            squares + [torch.zeros((), device=self.device)]).sum()
        if self.fsdp:                            # the shards' squares
            import torch.distributed as dist

            dist.all_reduce(gnorm_sq)
        gnorm = gnorm_sq.sqrt()
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

    def _agree(self, loss, weight, grads):
        """The loss of the whole batch, from every rank's loss weighed by
        its valid rows, and the gradients rescaled from the all-reduce's
        mean of the weighed ones to that batch's; a nonfinite loss on any
        rank makes the loss NaN on every rank, so all of them skip."""
        import torch.distributed as dist

        total = torch.stack([loss * weight, weight.float(),
                             (~torch.isfinite(loss)).float()])
        dist.all_reduce(total)
        torch._foreach_mul_(grads, self.world_size / total[1])
        return torch.where(total[2] > 0, torch.full_like(loss, math.nan),
                           total[0] / total[1])

    def evaluate_batch(self, batch, stage):
        """Evaluation on one batch (``core.py:717``): the forward and the
        objectives under ``torch.inference_mode``, the predictions and the
        loss brought to the host in one copy, then the host hook; returns
        the loss."""
        arrays = self._batch_to_device(batch)
        with torch.inference_mode():
            preds = self._call_forward(arrays, stage, None)
            loss = self.compute_objectives(preds, arrays, stage)
            preds_np, loss_val = _to_host(preds, loss)
        self.on_evaluate_batch_end(batch, preds_np, loss_val, stage)
        return loss_val

    # ------------------------------------------------------------ the loops
    def fit(self, epoch_counter, train_set, valid_set=None, progressbar=None,
            train_loader_kwargs={}, valid_loader_kwargs={}):
        """Epochs of training and validation (``core.py:728``)."""
        if not isinstance(train_set, (SaveableDataLoader, LoopedLoader)):
            train_set = self.make_dataloader(train_set, stage=Stage.TRAIN,
                                             **train_loader_kwargs)
        if valid_set is not None and not isinstance(
                valid_set, (SaveableDataLoader, LoopedLoader)):
            valid_set = self.make_dataloader(valid_set, stage=Stage.VALID,
                                             ckpt_prefix=None,
                                             **valid_loader_kwargs)
        self.on_fit_start()
        if progressbar is None:
            progressbar = not self.noprogressbar
        enable = progressbar and if_main_process()

        for epoch in epoch_counter:
            self.on_stage_start(Stage.TRAIN, epoch)
            if self.train_sampler is not None and hasattr(self.train_sampler,
                                                          "set_epoch"):
                self.train_sampler.set_epoch(epoch)
            # step and average start at 0 (reset after the last epoch) or
            # where an intra-epoch checkpoint left them, so a recovered
            # epoch averages as an uninterrupted one (the JAX loop resets
            # them here)
            last_ckpt_time = time.time()
            bar = _progress(train_set, enable)
            for batch in bar:
                self.step += 1
                loss = self.fit_batch(batch)
                self.avg_train_loss = self.update_average(loss,
                                                          self.avg_train_loss)
                if enable:
                    bar.set_postfix(train_loss=self.avg_train_loss)
                if self.debug and self.step == self.debug_batches:
                    break
                if (self.checkpointer is not None
                        and self.ckpt_interval_minutes > 0
                        and self._main_decides(
                            time.time() - last_ckpt_time
                            >= self.ckpt_interval_minutes * 60.0)):
                    self._save_intra_epoch_ckpt()
                    last_ckpt_time = time.time()
            self.on_stage_end(Stage.TRAIN, self.avg_train_loss, epoch)
            self.train_loss = self.avg_train_loss
            self.avg_train_loss = 0.0
            self.step = 0

            if valid_set is not None:
                self.on_stage_start(Stage.VALID, epoch)
                avg_valid_loss = 0.0
                for batch in _progress(valid_set, enable):
                    self.step += 1
                    loss = self.evaluate_batch(batch, stage=Stage.VALID)
                    avg_valid_loss = self.update_average(loss, avg_valid_loss)
                    if self.debug and self.step == self.debug_batches:
                        break
                self.step = 0
                self.on_stage_end(Stage.VALID, avg_valid_loss, epoch)

            if self.debug and epoch == self.debug_epochs:
                break

    def _main_decides(self, flag):
        """The main process's ``flag`` on every rank: each rank's own clock
        would have some ranks save while others step on."""
        if self.world_size == 1:
            return flag
        import torch.distributed as dist

        box = torch.tensor([float(flag)], device=self.device)
        dist.broadcast(box, src=0)
        return bool(box.item())

    def _save_intra_epoch_ckpt(self):
        """Intra-epoch checkpoint (``core.py:789``): only the newest is kept."""
        self.checkpointer.save_and_keep_only(
            end_of_epoch=False, num_to_keep=1,
            ckpt_predicate=lambda c: INTRA_EPOCH_CKPT_FLAG in c.meta,
            meta={INTRA_EPOCH_CKPT_FLAG: True}, verbosity=logging.DEBUG)

    def evaluate(self, test_set, max_key=None, min_key=None, progressbar=None,
                 test_loader_kwargs={}):
        """The test loop (``core.py:796``), from the best checkpoint by
        ``max_key``/``min_key``; returns the average loss."""
        if progressbar is None:
            progressbar = not self.noprogressbar
        if not isinstance(test_set, (SaveableDataLoader, LoopedLoader)):
            test_set = self.make_dataloader(test_set, Stage.TEST,
                                            **dict(test_loader_kwargs,
                                                   ckpt_prefix=None))
        self.on_evaluate_start(max_key=max_key, min_key=min_key)
        self.on_stage_start(Stage.TEST, epoch=None)
        self.step = 0
        avg_test_loss = 0.0
        for batch in _progress(test_set, progressbar and if_main_process()):
            self.step += 1
            loss = self.evaluate_batch(batch, stage=Stage.TEST)
            avg_test_loss = self.update_average(loss, avg_test_loss)
            if self.debug and self.step == self.debug_batches:
                break
        run_on_main(self.on_stage_end, args=[Stage.TEST, avg_test_loss, None])
        self.step = 0
        return avg_test_loss

    def update_average(self, loss, avg_loss):
        """Running average over ``self.step`` values (``core.py:821``);
        a nonfinite loss is left out."""
        if np.isfinite(loss):
            avg_loss -= avg_loss / self.step
            avg_loss += loss / self.step
        return avg_loss


def _to_host(preds, loss):
    """(predictions, loss) → (numpy predictions of the same structure, float
    loss), with every floating tensor and the loss in one device-to-host
    copy (as f32; bf16 logits keep their order)."""
    parts = list(preds) if isinstance(preds, (tuple, list)) else [preds]
    floats = [i for i, p in enumerate(parts)
              if torch.is_tensor(p) and p.is_floating_point()]
    flat = torch.cat([parts[i].reshape(-1).float() for i in floats]
                     + [loss.reshape(1).float()]).cpu().numpy()
    offset = 0
    out = []
    for i, p in enumerate(parts):
        if i in floats:
            out.append(flat[offset:offset + p.numel()].reshape(p.shape))
            offset += p.numel()
        else:
            out.append(p.cpu().numpy() if torch.is_tensor(p) else p)
    loss_val = float(flat[-1])
    if isinstance(preds, (tuple, list)):
        return tuple(out), loss_val
    return out[0], loss_val


def _shard_as(full, like):
    """The rank's shard of the whole tensor ``full``, placed as the DTensor
    ``like`` is (each rank cuts it from its own copy); anything else as
    it is."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    if not (isinstance(like, DTensor) and torch.is_tensor(full)
            and full.shape == like.shape):
        return full
    return distribute_tensor(full.to(like.device, like.dtype),
                             like.device_mesh, like.placements,
                             src_data_rank=None)


class _FullState:
    """A sharded module or optimizer as the checkpointer sees it under
    ``fsdp``: ``state_dict`` gathers every DTensor whole, on every rank
    (``collective``; the main process writes it), and ``load_state_dict``
    cuts each rank's shards from the whole tensors read back, placed as the
    parameters are. The files are those of one process, so a checkpoint
    of a sharded run recovers in one process and one process's in a
    sharded run."""

    collective = True

    def __init__(self, obj):
        self.obj = obj

    def state_dict(self):
        from torch.distributed.tensor import DTensor

        return tree_map(lambda t: t.full_tensor().cpu()
                        if isinstance(t, DTensor) else t,
                        self.obj.state_dict())

    def load_state_dict(self, data):
        if isinstance(self.obj, torch.optim.Optimizer):
            params = [p for g in self.obj.param_groups for p in g["params"]]
            data = dict(data, state={
                i: {k: _shard_as(v, params[int(i)]) for k, v in s.items()}
                for i, s in data["state"].items()})
        else:
            like = self.obj.state_dict()
            data = {k: _shard_as(v, like.get(k)) for k, v in data.items()}
        self.obj.load_state_dict(data)


class _BrainCounters:
    """The brain's checkpointable counters (``core.py:829``) and the states
    of its two generators (dropout masks and attention seeds), so that a
    recovered run draws the masks an uninterrupted one would."""

    def __init__(self, brain):
        self.brain = brain

    def state_dict(self):
        return {"step": self.brain.step,
                "avg_train_loss": float(self.brain.avg_train_loss),
                "optimizer_step": self.brain.optimizer_step,
                "generator": self.brain.generator.get_state(),
                "host_generator": self.brain.host_generator.get_state()}

    def load_state_dict(self, data, end_of_epoch=True):
        del end_of_epoch
        self.brain.step = data["step"]
        self.brain.avg_train_loss = data["avg_train_loss"]
        self.brain.optimizer_step = data["optimizer_step"]
        if "generator" not in data:
            # a JAX checkpoint: its PRNG key ("rng") has no torch.Generator
            # state, so the generators keep their own streams
            logger.info("The checkpoint holds no generator states; the "
                        "generators keep their own streams")
            return
        self.brain.generator.set_state(data["generator"])
        self.brain.host_generator.set_state(data["host_generator"])
