"""Artifact fetching (port of ``svt_speechbrain_tpu/pretrained/fetching.py``).

``fetch`` makes ``source/filename`` available under ``savedir`` by a symlink
to a local directory's file. Nothing is downloaded: a URL or a hub id
(``name`` or ``namespace/name`` that is not a local path) raises an error
that names the source and says that the port reads local paths only, where
the JAX package would download.
"""
from __future__ import annotations

import logging
import pathlib
import re

logger = logging.getLogger(__name__)

_HUB_ID = re.compile(r"^[A-Za-z0-9_.-]+(/[A-Za-z0-9_.-]+)?$")


def _is_remote(source):
    """A URL, or a hub id that names no local path."""
    text = str(source)
    if "://" in text:
        return True
    return (_HUB_ID.match(text) is not None and not text.startswith(".")
            and not pathlib.Path(text).exists())


def fetch(filename, source, savedir="./pretrained_model_checkpoints",
          overwrite=False, save_filename=None, use_auth_token=False):
    """``savedir/save_filename`` (default ``filename``) as a symlink to
    ``source/filename`` (``fetching.py:20``): an existing destination is
    reused unless ``overwrite``; a local directory's file is (re)linked; a
    missing directory or file raises ``FileNotFoundError``; a URL or hub id
    raises ``ValueError``. ``use_auth_token`` is accepted and unused:
    nothing is downloaded.

    Example
    -------
    >>> import os, tempfile
    >>> src, dst = tempfile.mkdtemp(), tempfile.mkdtemp()
    >>> _ = open(os.path.join(src, "weights.ckpt"), "w").write("x")
    >>> p = fetch("weights.ckpt", src, savedir=dst)
    >>> p.exists(), p.name, p.is_symlink()
    (True, 'weights.ckpt', True)
    >>> fetch("hyperparams.yaml", "speechbrain/some-model", savedir=dst)
    Traceback (most recent call last):
    ...
    ValueError: cannot fetch hyperparams.yaml from 'speechbrain/some-model': it is not a local directory, and there is no network: the port reads local paths only
    """
    if save_filename is None:
        save_filename = filename
    savedir = pathlib.Path(savedir)
    savedir.mkdir(parents=True, exist_ok=True)
    destination = savedir / save_filename
    if destination.exists() and not overwrite:
        logger.info(f"Fetch {filename}: using existing {destination}.")
        return destination
    if _is_remote(source):
        raise ValueError(
            f"cannot fetch {filename} from {str(source)!r}: it is not a "
            f"local directory, and there is no network: the port reads "
            f"local paths only")
    if not pathlib.Path(source).is_dir():
        raise FileNotFoundError(f"no directory {source}")
    sourcefile = pathlib.Path(source) / filename
    if not sourcefile.exists():
        raise FileNotFoundError(sourcefile)
    destination.unlink(missing_ok=True)
    destination.symlink_to(sourcefile.absolute())
    return destination
