"""Checkpointing (port of ``svt_speechbrain_tpu/utils/checkpoints.py``).

The on-disk layout of the JAX package: a directory per checkpoint
(``CKPT+<date>+<time>+<nn>/``) holding one ``<name>.ckpt`` file per
*recoverable* and a meta file (unixtime, end-of-epoch flag, the caller's
keys) written last, so that a directory without it is an unfinished save and
is never found. Files are written under a temporary name, synced and renamed
into place. ``save_and_keep_only`` keeps the best checkpoints by meta keys.

The meta file is JSON (``CKPT.json``). A recoverable is saved with
``torch.save`` of its ``state_dict()`` and restored through
``load_state_dict(data[, end_of_epoch])`` (modules, optimizers, schedulers,
counters, loaders), unless it has ``ckpt_save(path)`` /
``ckpt_load(path, end_of_epoch)`` methods (what
``register_checkpoint_hooks`` installs). ``PytreeHandle`` makes a
state dict held elsewhere checkpointable through a getter and a setter.

A checkpoint directory of the JAX package is found and recovered too: its
meta file is ``CKPT.yaml`` (read by ``config``'s reader), and each file's
format is told by its first bytes (``_file_format``): a zip is a
``torch.save``, a msgpack map is a flax tree, anything else the YAML of a
``state_dict()``. A flax tree fills a module (``convert_jax.
load_module_tree``) or an Adam/Adadelta optimizer (``convert_jax.
load_optax_state``, with the modules among the recoverables), and the JAX
Brain's ``model_states`` file fills the modules' BatchNorm statistics. The
YAML state dicts (counters, schedulers, the loader's position) have the
port's keys; the JAX brain's PRNG key has no counterpart, so the port's
generators keep their own streams.

Under a process group every rank saves (``save_checkpoint``,
``save_and_keep_only``) and recovers: the main process alone writes and
deletes, and all ranks return the same checkpoint. A recoverable whose
``collective`` attribute is true (a sharded module's or optimizer's state
in full, which every rank must help gather) has its ``state_dict()`` taken
on every rank.
"""
from __future__ import annotations

import inspect
import json
import logging
import os
import shutil
import time

import torch

from svt_speechbrain_tpu_torch.parallel.distributed import (_group,
                                                            ddp_barrier,
                                                            if_main_process)

logger = logging.getLogger(__name__)

CKPT_PREFIX = "CKPT"
METAFNAME = f"{CKPT_PREFIX}.json"
JAX_METAFNAME = f"{CKPT_PREFIX}.yaml"


def _torch_load(path):
    return torch.load(path, map_location="cpu", weights_only=True)


class PytreeHandle:
    """A recoverable over ``get()`` (returns a state dict: tensors, numbers,
    nested dicts and lists) and ``set(state)`` (installs a restored one)."""

    def __init__(self, get, set):
        self._get = get
        self._set = set

    def ckpt_save(self, path):
        torch.save(self._get(), path)

    def ckpt_load(self, path, end_of_epoch=True):
        del end_of_epoch
        self._set(_torch_load(path))


class Checkpoint:
    """A found checkpoint: ``path``, ``meta`` dict, ``paramfiles`` dict."""

    def __init__(self, path, meta, paramfiles):
        self.path = path
        self.meta = meta
        self.paramfiles = paramfiles

    def __repr__(self):
        return f"Checkpoint({self.path})"


def ckpt_recency(ckpt):
    """Recency importance key (``checkpoints.py:77``)."""
    return ckpt.meta["unixtime"]


def _publish(tmp_path, final_path):
    """Sync a fully written temporary file and rename it to its final name,
    so that a reader sees the whole file or none."""
    fd = os.open(tmp_path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)
    os.replace(tmp_path, final_path)


def _save_obj(obj, path):
    tmp = path + ".tmp"
    if hasattr(obj, "ckpt_save"):
        obj.ckpt_save(tmp)
    elif hasattr(obj, "state_dict"):
        torch.save(obj.state_dict(), tmp)
    else:
        raise TypeError(f"Don't know how to checkpoint {type(obj)}")
    _publish(tmp, path)


def _file_format(path):
    """"torch" (a zip: ``torch.save``), "msgpack" (a map: a flax tree the
    JAX package wrote) or "yaml" (the JAX package's state-dict text), by
    the file's first bytes."""
    with open(path, "rb") as f:
        head = f.read(4)
    if head == b"PK\x03\x04":
        return "torch"
    if head and (0x80 <= head[0] <= 0x8f or head[0] in (0xde, 0xdf)):
        return "msgpack"
    return "yaml"


def _read_yaml_file(path):
    from svt_speechbrain_tpu_torch.config import _Reader

    with open(path) as f:
        return _Reader(f.read()).read()


def _load_obj(obj, path, end_of_epoch, modules=None):
    """Recover ``obj`` from ``path``: through its ``ckpt_load``, a
    SentencePiece processor through its ``load`` (SpeechBrain's default
    hook for tokenizers), or by the file's format (``_file_format``).
    ``modules`` (name → module) place an optimizer's JAX state on their
    parameters."""
    if hasattr(obj, "ckpt_load"):
        obj.ckpt_load(path, end_of_epoch=end_of_epoch)
        return
    from svt_speechbrain_tpu_torch.tokenizers.spm_lite import (
        SentencePieceProcessor)

    if isinstance(obj, SentencePieceProcessor):
        obj.load(str(path))             # a tokenizer's .model file
        return
    if not hasattr(obj, "load_state_dict"):
        raise TypeError(f"Don't know how to recover {type(obj)}")
    fmt = _file_format(path)
    if fmt == "msgpack":
        from svt_speechbrain_tpu_torch import convert_jax

        tree = convert_jax.load_msgpack(path)
        if isinstance(obj, torch.nn.Module):
            convert_jax.load_module_tree(obj, tree)
        elif isinstance(obj, torch.optim.Optimizer):
            convert_jax.load_optax_state(obj, tree, modules or {})
        else:
            raise TypeError(f"{path}: a JAX tree does not recover a "
                            f"{type(obj).__name__}")
        return
    data = _torch_load(path) if fmt == "torch" else _read_yaml_file(path)
    if "end_of_epoch" in inspect.signature(obj.load_state_dict).parameters:
        obj.load_state_dict(data, end_of_epoch=end_of_epoch)
    else:
        obj.load_state_dict(data)


class Checkpointer:
    """Saves and recovers named recoverables (``checkpoints.py:129``).

    Example
    -------
    >>> import tempfile
    >>> from svt_speechbrain_tpu_torch.utils.epoch_loop import EpochCounter
    >>> counter = EpochCounter(limit=10)
    >>> counter.current = 3
    >>> ckptr = Checkpointer(tempfile.mkdtemp(), recoverables={"epoch": counter})
    >>> _ = ckptr.save_checkpoint(meta={"loss": 1.5}, verbosity=0)
    >>> counter.current = 7                      # diverge, then recover
    >>> _ = ckptr.recover_if_possible()
    >>> counter.current
    3
    >>> ckptr.find_checkpoint().meta["loss"]
    1.5
    """

    def __init__(self, checkpoints_dir, recoverables=None,
                 allow_partial_load=False):
        self.checkpoints_dir = str(checkpoints_dir)
        os.makedirs(self.checkpoints_dir, exist_ok=True)
        self.recoverables = {}
        if recoverables is not None:
            self.add_recoverables(recoverables)
        self.allow_partial_load = allow_partial_load

    def add_recoverable(self, name, obj):
        self.recoverables[name] = obj

    def add_recoverables(self, recoverables):
        self.recoverables.update(recoverables)

    # ------------------------------------------------------------- saving
    def save_checkpoint(self, meta={}, end_of_epoch=True, name=None,
                        verbosity=logging.INFO):
        """Save every recoverable, then the meta file (``checkpoints.py:164``);
        on every rank of a process group, the main process writing."""
        main = if_main_process()
        ckpt_dir = (self._new_checkpoint_dirpath() if name is None
                    else os.path.join(self.checkpoints_dir,
                                      f"{CKPT_PREFIX}+{name}"))
        if main:
            os.makedirs(ckpt_dir, exist_ok=True)
        paramfiles = {}
        for name_, obj in self.recoverables.items():
            paramfiles[name_] = os.path.join(ckpt_dir, f"{name_}.ckpt")
            if getattr(obj, "collective", False):
                state = obj.state_dict()
                if main:
                    tmp = paramfiles[name_] + ".tmp"
                    torch.save(state, tmp)
                    _publish(tmp, paramfiles[name_])
            elif main:
                _save_obj(obj, paramfiles[name_])
        saved_meta = (self._save_checkpoint_metafile(
            os.path.join(ckpt_dir, METAFNAME), meta, end_of_epoch)
            if main else None)
        group = _group()
        if group is not None:     # the main process's name and meta, written
            box = [(ckpt_dir, saved_meta)]
            group.broadcast_object_list(box, src=0)
            ckpt_dir, saved_meta = box[0]
            paramfiles = {k: os.path.join(ckpt_dir, os.path.basename(v))
                          for k, v in paramfiles.items()}
        logger.log(verbosity, f"Saved an end-of-epoch checkpoint in {ckpt_dir}"
                   if end_of_epoch
                   else f"Saved an intra-epoch checkpoint in {ckpt_dir}")
        return Checkpoint(ckpt_dir, saved_meta, paramfiles)

    def save_and_keep_only(self, meta={}, end_of_epoch=True, name=None,
                           num_to_keep=1, keep_recent=True, importance_keys=[],
                           max_keys=[], min_keys=[], ckpt_predicate=None,
                           verbosity=logging.INFO):
        """Save, then delete all but the best ``num_to_keep`` per key
        (``checkpoints.py:187``)."""
        if keep_recent:
            importance_keys = list(importance_keys) + [ckpt_recency]
        self.save_checkpoint(meta=meta, end_of_epoch=end_of_epoch, name=name,
                             verbosity=verbosity)
        if if_main_process():
            self.delete_checkpoints(
                num_to_keep=num_to_keep, max_keys=max_keys, min_keys=min_keys,
                importance_keys=importance_keys,
                ckpt_predicate=ckpt_predicate, verbosity=verbosity)
        ddp_barrier()

    # ------------------------------------------------------------ finding
    def list_checkpoints(self):
        checkpoints = []
        for entry in sorted(os.listdir(self.checkpoints_dir)):
            path = os.path.join(self.checkpoints_dir, entry)
            metafile = os.path.join(path, METAFNAME)
            jax_metafile = os.path.join(path, JAX_METAFNAME)
            if os.path.isdir(path) and os.path.exists(metafile):
                with open(metafile) as f:
                    meta = json.load(f)
            elif os.path.isdir(path) and os.path.exists(jax_metafile):
                meta = _read_yaml_file(jax_metafile)
            else:
                continue
            paramfiles = {f_[:-5]: os.path.join(path, f_)
                          for f_ in os.listdir(path) if f_.endswith(".ckpt")}
            checkpoints.append(Checkpoint(path, meta, paramfiles))
        return checkpoints

    def find_checkpoint(self, importance_key=None, max_key=None, min_key=None,
                        ckpt_predicate=None):
        found = self.find_checkpoints(
            importance_key=importance_key, max_key=max_key, min_key=min_key,
            ckpt_predicate=ckpt_predicate, max_num_checkpoints=1)
        return found[0] if found else None

    def find_checkpoints(self, importance_key=None, max_key=None, min_key=None,
                         ckpt_predicate=None, max_num_checkpoints=None):
        if importance_key is None and min_key is None and max_key is None:
            importance_key = ckpt_recency
        if max_key and not importance_key:
            def importance_key(ckpt):
                return ckpt.meta[max_key]
        elif min_key and not importance_key:
            def importance_key(ckpt):
                return -ckpt.meta[min_key]
        ckpts = self.list_checkpoints()
        if ckpt_predicate is not None:
            ckpts = [c for c in ckpts if ckpt_predicate(c)]
        if max_key or min_key:
            key_name = max_key or min_key
            ckpts = [c for c in ckpts if key_name in c.meta]
        ranked = sorted(ckpts, key=importance_key, reverse=True)
        if max_num_checkpoints is not None:
            ranked = ranked[:max_num_checkpoints]
        return ranked

    # ---------------------------------------------------------- recovery
    def recover_if_possible(self, importance_key=None, max_key=None,
                            min_key=None, ckpt_predicate=None):
        chosen_ckpt = self.find_checkpoint(importance_key, max_key, min_key,
                                           ckpt_predicate)
        if chosen_ckpt is not None:
            self.load_checkpoint(chosen_ckpt)
        else:
            logger.info("Would load a checkpoint here, but none found yet.")
        return chosen_ckpt

    def load_checkpoint(self, checkpoint):
        end_of_epoch = checkpoint.meta["end-of-epoch"]
        logger.info(f"Loading a checkpoint from {checkpoint.path}")
        modules = {name: obj for name, obj in self.recoverables.items()
                   if isinstance(obj, torch.nn.Module)}
        for name, obj in self.recoverables.items():
            loadpath = checkpoint.paramfiles.get(name)
            if loadpath is None:
                if self.allow_partial_load:
                    logger.warning(f"Loading checkpoint: {checkpoint.path}, "
                                   f"missing {name}")
                    continue
                raise RuntimeError(
                    f"Loading checkpoint from {checkpoint.path}, but missing "
                    f"a load path for {name}")
            _load_obj(obj, loadpath, end_of_epoch, modules)
        states = checkpoint.paramfiles.get("model_states")
        if states is not None and "model_states" not in self.recoverables:
            # the JAX Brain keeps the BatchNorm statistics apart from the
            # parameters; the port's modules hold them as buffers
            from svt_speechbrain_tpu_torch import convert_jax

            for name, state in convert_jax.load_msgpack(states).items():
                convert_jax.load_running_stats(modules[name], state)

    # ---------------------------------------------------------- deleting
    def delete_checkpoints(self, *, num_to_keep=1, min_keys=None,
                           max_keys=None, importance_keys=[ckpt_recency],
                           ckpt_predicate=None, verbosity=logging.INFO):
        """Keep the best ``num_to_keep`` per importance key, delete the rest
        (``checkpoints.py:271``)."""
        if isinstance(importance_keys, str):
            raise TypeError("Importance keys must be a list of callables")
        importance_keys = list(importance_keys)
        for key in max_keys or []:
            importance_keys.append(
                lambda c, key=key: c.meta.get(key, float("-inf")))
        for key in min_keys or []:
            importance_keys.append(
                lambda c, key=key: -c.meta.get(key, float("inf")))
        potential = self.list_checkpoints()
        if ckpt_predicate is not None:
            potential = [c for c in potential if ckpt_predicate(c)]
        protected = set()
        for importance_key in importance_keys:
            for ckpt in sorted(potential, key=importance_key,
                               reverse=True)[:num_to_keep]:
                protected.add(ckpt.path)
        for ckpt in potential:
            if ckpt.path not in protected:
                shutil.rmtree(ckpt.path)
                logger.log(verbosity, f"Deleted checkpoint in {ckpt.path}")

    # ----------------------------------------------------------- helpers
    def _new_checkpoint_dirpath(self):
        stamp = time.strftime("%Y-%m-%d+%H-%M-%S", time.localtime(time.time()))
        suffix_num = 0
        while os.path.exists(os.path.join(
                self.checkpoints_dir,
                f"{CKPT_PREFIX}+{stamp}+{suffix_num:02d}")):
            suffix_num += 1
        return os.path.join(self.checkpoints_dir,
                            f"{CKPT_PREFIX}+{stamp}+{suffix_num:02d}")

    def _save_checkpoint_metafile(self, fpath, meta_to_include={},
                                  end_of_epoch=True):
        meta = {"unixtime": time.time(), "end-of-epoch": end_of_epoch}
        meta.update(meta_to_include)
        tmp = fpath + ".tmp"
        with open(tmp, "w") as f:
            json.dump(meta, f)
        _publish(tmp, fpath)
        return meta


def average_state_dicts(state_dicts):
    """Elementwise mean of floating tensors across state dicts of the same
    structure; every other value is taken from the first
    (``checkpoints.py:406``)."""
    dicts = list(state_dicts)
    if not dicts:
        raise ValueError("no state dicts to average")
    out = {}
    for key, first in dicts[0].items():
        if isinstance(first, dict):
            out[key] = average_state_dicts(d[key] for d in dicts)
        elif torch.is_tensor(first) and first.is_floating_point():
            out[key] = (torch.stack([d[key].double() for d in dicts]).mean(0)
                        .to(first.dtype))
        else:
            out[key] = first
    return out


def average_checkpoints(checkpoint_list, recoverable_name,
                        parameter_loader=None, averager=None):
    """The mean of one recoverable's saved state dicts across checkpoints
    (``checkpoints.py:321``). ``parameter_loader(path)`` reads a state dict
    (``torch.load`` by default) and ``averager(state_dicts)`` combines them
    (``average_state_dicts`` by default)."""
    parameter_loader = parameter_loader or _torch_load
    averager = averager or average_state_dicts
    return averager(parameter_loader(ckpt.paramfiles[recoverable_name])
                    for ckpt in checkpoint_list)


# --------------------------------------------------------------------------
# Hook registry (``checkpoints.py:338-394``): classes decorate methods with
# @mark_as_saver/@mark_as_loader (and @mark_as_transfer), and
# @register_checkpoint_hooks turns them into the ckpt_save/ckpt_load
# protocol the Checkpointer speaks.

def mark_as_saver(method):
    """Mark ``method(self, path)`` as the class's checkpoint saver."""
    if len(inspect.signature(method).parameters) < 2:
        raise TypeError("Checkpoint saver must take (self, path)")
    method._speechbrain_saver = True
    return method


def mark_as_loader(method):
    """Mark ``method(self, path, end_of_epoch=...)`` as the loader."""
    method._speechbrain_loader = True
    return method


def mark_as_transfer(method):
    """Mark ``method(self, path)`` as the parameter-transfer hook."""
    method._speechbrain_transfer = True
    return method


def get_default_hook(obj, default_hooks):
    """The hook of ``obj``'s class or its nearest base in ``default_hooks``,
    or None (``checkpoints.py:397``).

    Example
    -------
    >>> get_default_hook(True, {int: "int hook"})
    'int hook'
    """
    for cls in type(obj).__mro__:
        if cls in default_hooks:
            return default_hooks[cls]
    return None


def register_checkpoint_hooks(cls):
    """Class decorator installing ``ckpt_save``/``ckpt_load``/
    ``ckpt_transfer`` from the marked methods.

    Example
    -------
    >>> import os, tempfile
    >>> @register_checkpoint_hooks
    ... class Note:
    ...     text = ""
    ...     @mark_as_saver
    ...     def save(self, path):
    ...         open(path, "w").write(self.text)
    ...     @mark_as_loader
    ...     def load(self, path, end_of_epoch=True):
    ...         self.text = open(path).read()
    >>> note = Note()
    >>> note.text = "kept"
    >>> ckptr = Checkpointer(tempfile.mkdtemp(), {"note": note})
    >>> _ = ckptr.save_checkpoint(verbosity=0)
    >>> note.text = ""
    >>> _ = ckptr.recover_if_possible()
    >>> note.text
    'kept'
    """
    saver = loader = transfer = None
    for name, method in cls.__dict__.items():
        if getattr(method, "_speechbrain_saver", False):
            saver = name
        if getattr(method, "_speechbrain_loader", False):
            loader = name
        if getattr(method, "_speechbrain_transfer", False):
            transfer = name
    if saver is not None and "ckpt_save" not in cls.__dict__:
        def ckpt_save(self, path, _name=saver):
            getattr(self, _name)(path)
        cls.ckpt_save = ckpt_save
    if loader is not None and "ckpt_load" not in cls.__dict__:
        def ckpt_load(self, path, end_of_epoch=True, _name=loader):
            method = getattr(self, _name)
            if "end_of_epoch" in inspect.signature(method).parameters:
                method(path, end_of_epoch=end_of_epoch)
            else:
                method(path)
        cls.ckpt_load = ckpt_load
    if transfer is not None and "ckpt_transfer" not in cls.__dict__:
        def ckpt_transfer(self, path, _name=transfer):
            getattr(self, _name)(path)
        cls.ckpt_transfer = ckpt_transfer
    return cls
