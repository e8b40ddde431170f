"""Main-process helpers (port of ``svt_speechbrain_tpu/parallel/distributed.py``).

``run_on_main``/``if_main_process`` gate work that one process does for all
(experiment folder, checkpoint writes, data preparation) on the rank of the
``torch.distributed`` process group when one is initialised; without one
the caller is the only, and so the main, process. ``ddp_init_group`` sets
up the group of a multi-process launch (``torchrun``): NCCL on CUDA, gloo on
the CPU, or the backend the run options name.
"""
from __future__ import annotations

import functools
import logging
import os

logger = logging.getLogger(__name__)


def _group():
    import torch.distributed as dist

    return dist if dist.is_available() and dist.is_initialized() else None


def if_main_process():
    """True on rank 0, or without a process group (``distributed.py:19``)."""
    dist = _group()
    return dist is None or dist.get_rank() == 0


def main_process_only(function):
    """Decorator: run only on the main process, then wait at a barrier."""

    @functools.wraps(function)
    def main_proc_wrapped_func(*args, **kwargs):
        result = None
        if if_main_process():
            result = function(*args, **kwargs)
        ddp_barrier()
        return result

    return main_proc_wrapped_func


def run_on_main(func, args=None, kwargs=None, post_func=None, post_args=None,
                post_kwargs=None, run_post_on_main=False):
    """Run ``func`` on the main process only, wait at a barrier, then run
    ``post_func`` on the other processes (and on the main one with
    ``run_post_on_main``) (``distributed.py:44``).

    Example
    -------
    >>> if_main_process()
    True
    >>> acc = []
    >>> run_on_main(acc.append, args=[1],
    ...             post_func=acc.append, post_args=[2], run_post_on_main=True)
    >>> acc
    [1, 2]
    """
    if if_main_process():
        func(*(args or []), **(kwargs or {}))
    ddp_barrier()
    if post_func is not None:
        if run_post_on_main or not if_main_process():
            post_func(*(post_args or []), **(post_kwargs or {}))
        ddp_barrier()


def ddp_barrier():
    """A barrier across the process group; nothing without one."""
    dist = _group()
    if dist is not None:
        dist.barrier()


def ddp_init_group(run_opts=None):
    """Set up the process group of a multi-process launch
    (``distributed.py:91``) from the launcher's environment (``WORLD_SIZE``,
    ``RANK``, ``LOCAL_RANK``, ``MASTER_ADDR``/``MASTER_PORT``). One process
    without ``distributed_launch`` needs none, and nothing happens.

    ``run_opts``: ``distributed_backend`` (default NCCL when ``device`` is
    CUDA, gloo on the CPU; neither replaces the other), ``device`` (a CUDA
    device becomes ``cuda:<LOCAL_RANK>``, set in ``run_opts`` and made
    current), ``distributed_timeout`` (seconds). Under an explicit launch
    (``distributed_launch`` or ``WORLD_SIZE`` above 1) a group that cannot
    be set up raises ``RuntimeError``: one process never trains on its part
    of the data alone."""
    import datetime

    import torch
    import torch.distributed as dist

    run_opts = {} if run_opts is None else run_opts
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if not run_opts.get("distributed_launch") and world <= 1:
        return
    if dist.is_initialized():
        return
    device = str(run_opts.get("device") or
                 ("cuda" if torch.cuda.is_available() else "cpu"))
    backend = run_opts.get("distributed_backend") or (
        "nccl" if device.startswith("cuda") else "gloo")
    local_rank = int(os.environ.get("LOCAL_RANK", "0"))
    if device.startswith("cuda"):
        run_opts["device"] = f"cuda:{local_rank}"
    timeout = datetime.timedelta(
        seconds=float(run_opts.get("distributed_timeout", 1800)))
    try:
        if device.startswith("cuda"):
            torch.cuda.set_device(local_rank)
        dist.init_process_group(
            backend=backend, init_method="env://", timeout=timeout,
            world_size=world, rank=int(os.environ.get("RANK", "0")))
    except Exception as e:
        raise RuntimeError(
            f"a distributed launch (WORLD_SIZE={world}) was asked for but "
            f"the {backend} process group failed to initialise: {e}") from e
    logger.info(f"Initialized the {backend} process group: rank "
                f"{dist.get_rank()} of {dist.get_world_size()}")
