"""Sharded checkpoints on ``torch.distributed.checkpoint`` (the port of
``svt_speechbrain_tpu/utils/orbax_checkpoints.py``, whose backend is orbax).

``OrbaxCheckpointer`` keeps the JAX class's recoverable registry
(``add_recoverable(s)``, ``save_checkpoint(meta, step)``,
``recover_if_possible(step)``, ``max_to_keep``) over DCP: each rank writes
its own shards of a step into ``<dir>/<step>/`` (a replicated tensor once),
and a step restores onto any number of ranks, FSDP-sharded or whole, since
DCP reads each rank's part by the tensors' names and placements. Modules go
through ``get_model_state_dict`` and optimizers through
``get_optimizer_state_dict`` (their state keyed by parameter name, not by
position), so an optimizer must be registered with the module it steps
(``add_recoverable(name, optimizer, module=...)``); any other object with
``state_dict``/``load_state_dict`` is saved as it is. ``async_save``
stages the tensors and writes them in the background; the next save,
``recover_if_possible`` or ``wait_until_finished`` waits for it. The step's
``meta`` is ``meta.json`` beside the shards, written by the main process.

Example
-------
>>> import tempfile, torch
>>> model = torch.nn.Linear(2, 2)
>>> ck = OrbaxCheckpointer(tempfile.mkdtemp(), recoverables={"model": model})
>>> step = ck.save_checkpoint(meta={"loss": 1.0})
>>> with torch.no_grad():
...     _ = model.weight.zero_()
>>> ck.recover_if_possible(), bool(model.weight.abs().sum() > 0)
(0, True)
"""
from __future__ import annotations

import json
import logging
import os
import shutil

import torch

from svt_speechbrain_tpu_torch.parallel.distributed import (ddp_barrier,
                                                            if_main_process)

logger = logging.getLogger(__name__)


class OrbaxCheckpointer:
    """The recoverable registry of the JAX class over DCP (above)."""

    def __init__(self, checkpoints_dir, recoverables=None, max_to_keep=1,
                 async_save=False):
        self.checkpoints_dir = os.path.abspath(str(checkpoints_dir))
        if if_main_process():
            os.makedirs(self.checkpoints_dir, exist_ok=True)
        self.recoverables = {}
        self.owners = {}
        self.add_recoverables(recoverables or {})
        self.max_to_keep = max_to_keep
        self.async_save = async_save
        self._pending = None
        self._async_group = None
        self._step = 0

    def add_recoverable(self, name, obj, module=None):
        """Register ``obj``; an optimizer names the ``module`` it steps."""
        if isinstance(obj, torch.optim.Optimizer) and module is None:
            raise ValueError(f"optimizer {name!r} needs the module it steps "
                             f"(module=...)")
        self.recoverables[name] = obj
        if module is not None:
            self.owners[name] = module

    def add_recoverables(self, recoverables):
        for name, obj in recoverables.items():
            self.add_recoverable(name, obj)

    def _state(self):
        from torch.distributed.checkpoint.state_dict import (
            get_model_state_dict, get_optimizer_state_dict)

        state = {}
        for name, obj in self.recoverables.items():
            if isinstance(obj, torch.nn.Module):
                state[name] = get_model_state_dict(obj)
            elif isinstance(obj, torch.optim.Optimizer):
                state[name] = get_optimizer_state_dict(self.owners[name], obj)
            else:
                state[name] = obj.state_dict()
        return state

    def _steps(self):
        if not os.path.isdir(self.checkpoints_dir):
            return []
        return sorted(int(d) for d in os.listdir(self.checkpoints_dir)
                      if d.isdigit() and os.path.exists(os.path.join(
                          self.checkpoints_dir, d, ".metadata")))

    def wait_until_finished(self):
        """Wait for an asynchronous save, then drop the oldest steps."""
        if self._pending is not None:
            self._pending.result()
            self._pending = None
            self._prune()

    def _prune(self):
        ddp_barrier()
        if if_main_process():
            for step in self._steps()[:-self.max_to_keep or None]:
                shutil.rmtree(os.path.join(self.checkpoints_dir, str(step)))
        ddp_barrier()

    def save_checkpoint(self, meta=None, step=None):
        """Write every recoverable as step ``step`` (the next one by
        default); returns the step."""
        import torch.distributed as dist
        import torch.distributed.checkpoint as dcp

        self.wait_until_finished()
        step = self._step if step is None else step
        path = os.path.join(self.checkpoints_dir, str(step))
        if if_main_process():
            os.makedirs(path, exist_ok=True)
            with open(os.path.join(path, "meta.json"), "w") as f:
                json.dump(dict(meta or {}), f)
        ddp_barrier()
        state = self._state()
        if self.async_save:
            group = None
            if dist.is_initialized() and dist.get_backend() == "nccl":
                # the background write's collectives run on CPU tensors
                if self._async_group is None:
                    self._async_group = dist.new_group(backend="gloo")
                group = self._async_group
            self._pending = dcp.async_save(state, checkpoint_id=path,
                                           process_group=group)
        else:
            dcp.save(state, checkpoint_id=path)
            self._prune()
        self._step = step + 1
        logger.info(f"Saved checkpoint at step {step}")
        return step

    def recover_if_possible(self, step=None):
        """Load step ``step`` (the newest complete one by default) into the
        recoverables; returns the step, or None if there is none."""
        import torch.distributed.checkpoint as dcp
        from torch.distributed.checkpoint.state_dict import (
            set_model_state_dict, set_optimizer_state_dict)

        self.wait_until_finished()
        steps = self._steps()
        if step is None:
            step = steps[-1] if steps else None
        if step is None:
            logger.info("No checkpoint found.")
            return None
        state = self._state()
        dcp.load(state, checkpoint_id=os.path.join(self.checkpoints_dir,
                                                   str(step)))
        for name, obj in self.recoverables.items():
            if isinstance(obj, torch.nn.Module):
                set_model_state_dict(obj, state[name])
            elif isinstance(obj, torch.optim.Optimizer):
                set_optimizer_state_dict(self.owners[name], obj, state[name])
            else:
                obj.load_state_dict(state[name])
        self._step = step + 1
        logger.info(f"Restored checkpoint from step {step}")
        return step
