"""Logging set-up (port of ``svt_speechbrain_tpu/utils/logger.py``)."""
from __future__ import annotations

import logging
import math
import os
import sys

ORDERS_ABBREV = {
    -24: "y", -21: "z", -18: "a", -15: "f", -12: "p", -9: "n", -6: "µ",
    -3: "m", 0: "", 3: "k", 6: "M", 9: "G", 12: "T", 15: "P", 18: "E",
    21: "Z", 24: "Y",
}


def setup_logging(log_file=None, console_level=logging.INFO,
                  file_level=logging.DEBUG):
    """Console at INFO and, with ``log_file``, a file at DEBUG
    (``logger.py:16``); libraries that log their internals are capped so
    the experiment's ``log.txt`` stays readable."""
    root = logging.getLogger()
    root.setLevel(logging.DEBUG)
    for h in list(root.handlers):
        root.removeHandler(h)
    console = logging.StreamHandler(sys.stdout)
    console.setLevel(console_level)
    console.setFormatter(logging.Formatter("%(name)s - %(message)s"))
    root.addHandler(console)
    if log_file is not None:
        os.makedirs(os.path.dirname(os.path.abspath(log_file)), exist_ok=True)
        fileh = logging.FileHandler(log_file)
        fileh.setLevel(file_level)
        fileh.setFormatter(logging.Formatter(
            "%(asctime)s - %(levelname)s - %(name)s - %(message)s"))
        root.addHandler(fileh)
    for noisy in ("urllib3", "filelock"):
        logging.getLogger(noisy).setLevel(logging.INFO)
    # torch's compiler logs its set-up at INFO
    logging.getLogger("torch").setLevel(logging.WARNING)


def format_order_of_magnitude(number, abbreviate=True):
    """3.5M-style formatting (``logger.py:42``); ``abbreviate`` is accepted
    and, as in the JAX package, the abbreviations are always used.

    Example
    -------
    >>> format_order_of_magnitude(3_500_000)
    ('3.5', 'M')
    >>> format_order_of_magnitude(950)
    ('950.0', '')
    """
    order = (3 * math.floor(math.log(math.fabs(number), 1000))
             if number != 0 else 0)
    order = min(max(order, min(ORDERS_ABBREV)), max(ORDERS_ABBREV))
    return f"{number / 10 ** order:3.1f}", ORDERS_ABBREV[order]


def get_environment_description():
    """Python, packages, platform and CUDA devices (``logger.py:62``; the
    experiment folder's ``env.log``)."""
    import importlib.metadata as md
    import platform

    import torch

    deps = sorted(f"{dist.metadata['Name']}=={dist.version}"
                  for dist in md.distributions()
                  if dist.metadata["Name"] is not None)
    if torch.cuda.is_available():
        devices = "\n".join(torch.cuda.get_device_name(i)
                            for i in range(torch.cuda.device_count()))
    else:
        devices = "none"
    return "\n".join([
        "Python version:\n" + sys.version + "\n",
        "Installed Python packages:\n" + "\n".join(deps) + "\n",
        "Platform:\n" + platform.platform() + "\n",
        f"PyTorch {torch.__version__}, CUDA {torch.version.cuda}; CUDA "
        f"devices:\n{devices}\n"])


class TqdmCompatibleStreamHandler(logging.StreamHandler):
    """A stream handler that writes through ``tqdm.write`` so progress bars
    survive log lines (``logger.py:88``); a plain emit without tqdm."""

    def emit(self, record):
        try:
            from tqdm import tqdm

            tqdm.write(self.format(record), file=self.stream)
            self.flush()
        except ImportError:
            super().emit(record)
        except Exception:
            self.handleError(record)
