"""Declarative pretrained-parameter transfer (port of
``svt_speechbrain_tpu/utils/parameter_transfer.py``).

``Pretrainer`` maps loadable names to source files (local paths only; see
``pretrained/fetching.py``), collects them into a directory as
``<name>.ckpt`` and loads each into its object through the checkpointer's
loader, ``checkpoints._load_obj``, which tells the file's format by its
first bytes: a ``torch.save`` state dict fills an ``nn.Module`` (or any
object with ``load_state_dict``), and a JAX export (msgpack, as the JAX
recipes' ``wav2vec2.msgpack``/``model.msgpack``) fills an ``nn.Module``
through ``convert_jax.load_module_tree``.
"""
from __future__ import annotations

import logging
import pathlib

from svt_speechbrain_tpu_torch.pretrained.fetching import fetch
from svt_speechbrain_tpu_torch.utils.checkpoints import _load_obj

logger = logging.getLogger(__name__)


class Pretrainer:
    """Collect-then-load parameter transfer (``parameter_transfer.py:19``).

    Example
    -------
    >>> import os, tempfile, torch
    >>> from svt_speechbrain_tpu_torch.nnet.linear import Linear
    >>> src = tempfile.mkdtemp()
    >>> donor = Linear(3, 2)
    >>> torch.save(donor.state_dict(), os.path.join(src, "model.pt"))
    >>> head = Linear(3, 2)
    >>> pre = Pretrainer(collect_in=tempfile.mkdtemp(),
    ...                  loadables={"model": head},
    ...                  paths={"model": os.path.join(src, "model.pt")})
    >>> _ = pre.collect_files()
    >>> pre.load_collected()
    >>> bool(torch.equal(head.w, donor.w))
    True
    """

    def __init__(self, collect_in="./model_checkpoints", loadables=None,
                 paths=None, custom_hooks=None):
        self.loadables = {}
        self.collect_in = pathlib.Path(collect_in)
        if loadables is not None:
            self.add_loadables(loadables)
        self.paths = {}
        if paths is not None:
            self.add_defaults(paths)
        self.custom_hooks = custom_hooks or {}

    def add_loadables(self, loadables):
        self.loadables.update(loadables)

    def add_defaults(self, paths):
        self.paths.update(paths)

    @staticmethod
    def split_path(path):
        """(source directory, file name) of ``path``; "./" when it names
        a file only."""
        if "/" in str(path):
            return str(path).rsplit("/", 1)
        return "./", str(path)

    def collect_files(self, default_source=None):
        """Fetch every loadable's file into ``collect_in`` as
        ``<name>.ckpt`` (``parameter_transfer.py:66``); returns name →
        path. A path without a directory names a file of
        ``default_source`` when one is given (the JAX package reads it
        from the working directory), so that an export folder's
        ``hyperparams.yaml`` can name its files."""
        self.collect_in.mkdir(parents=True, exist_ok=True)
        loadable_paths = {}
        for name in self.loadables:
            save_filename = name + ".ckpt"
            if name in self.paths:
                source, filename = self.split_path(self.paths[name])
                if default_source is not None and \
                        "/" not in str(self.paths[name]):
                    source = default_source
            elif default_source is not None:
                filename = save_filename
                source = default_source
            else:
                raise ValueError(f"No path for loadable {name} and no "
                                 f"default source")
            loadable_paths[name] = fetch(filename, source, self.collect_in,
                                         save_filename=save_filename)
        return loadable_paths

    def load_collected(self):
        """Load each collected file into its object, or through its
        ``custom_hooks`` entry (``parameter_transfer.py:87``)."""
        for name, obj in self.loadables.items():
            path = str(self.collect_in / (name + ".ckpt"))
            if name in self.custom_hooks:
                self.custom_hooks[name](obj, path)
            else:
                _load_obj(obj, path, end_of_epoch=False)
            logger.info(f"Loaded pretrained {name} from {path}")
