"""Dynamic import + shell helpers (a copy of
``svt_speechbrain_tpu/utils/superpowers.py``)."""
from __future__ import annotations

import importlib.util
import logging
import subprocess

logger = logging.getLogger(__name__)


def import_from_path(path):
    """Import a python module from an arbitrary file path
    (reference ``superpowers.py:20``).

    Example
    -------
    >>> import os, tempfile
    >>> d = tempfile.mkdtemp()
    >>> path = os.path.join(d, "mymod.py")
    >>> _ = open(path, "w").write("VALUE = 42\\n")
    >>> import_from_path(path).VALUE
    42
    """
    spec = importlib.util.spec_from_file_location("external_module", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def run_shell(cmd):
    """Run a shell command, returning (output, err, return_code)
    (reference ``superpowers.py:51``).

    Example
    -------
    >>> out, err, rc = run_shell("echo hello")
    >>> out.decode().strip(), rc
    ('hello', 0)
    """
    p = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                         shell=True)
    output, err = p.communicate()
    if p.returncode != 0:
        logger.error(err.decode(errors="replace"))
    logger.debug(output.decode(errors="replace"))
    return output, err, p.returncode
