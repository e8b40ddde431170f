"""Main-process helpers (port of ``svt_speechbrain_tpu/parallel/distributed.py``).

``run_on_main``/``if_main_process`` gate work that one process does for all
(experiment folder, checkpoint writes, data preparation) on the rank of the
``torch.distributed`` process group when one is initialised; without one
the caller is the only, and so the main, process. Training on more than one
process is not ported yet (ROADMAP.md queue 1 item 16): ``ddp_init_group``
does nothing for one process and raises for more.
"""
from __future__ import annotations

import functools
import os


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
    (``distributed.py:91``). One process (``WORLD_SIZE`` 1 or unset) needs
    none, so nothing happens; more than one raises until data parallelism
    is ported. ``run_opts`` is accepted for the recipes' call."""
    del run_opts
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world > 1:
        raise NotImplementedError(
            f"a distributed launch (WORLD_SIZE={world}) is not ported yet "
            f"(ROADMAP.md queue 1 item 16); run one process")
